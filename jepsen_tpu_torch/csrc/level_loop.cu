// Fused BFS level loop of the linearizability search, for Hopper (sm_90a).
//
// Replaces jepsen_tpu/checker/pallas_level.py::build_pallas_step_fn (the
// Pallas TPU kernel).  One launch runs one slice of one search: up to
// lvl_cap levels of mask phase -> crash closure -> determinate successors
// -> exact all-pairs dominance prune -> compaction, and returns the packed
// carry.  It computes bit for bit what jepsen_tpu_torch/checker/step.py
// computes with the all-pairs prune: same survivor order (row-major,
// lane-ascending), same configs, same overflow / bail / revert behaviour,
// for every frontier width F <= 2048, where the card's torch step prunes
// all-pairs at both of its sites (4F <= 8192 rows).
//
// What bounds it: serial per-level latency on one SM.  A level is a chain
// of dependent phases separated by block barriers; a slice moves its
// tables and carry once (tens of KB) and does far fewer integer operations
// per level than the card's rate would allow.  The design attacks the
// latency of that chain:
//
//   * Tables in shared memory, brought in by the Tensor Memory
//     Accelerator: at launch one thread issues 1-D bulk copies
//     (cp.async.bulk ... mbarrier::complete_tx) of the ten history tables,
//     completed on an mbarrier, while the other threads load the carry.
//     Every det_*, sfx and crash_* read of the mask phase and the
//     successor build is then a shared-memory read.  Where the tables do
//     not fit beside the frontier in the 227 KB a block may opt into, the
//     same code reads them from device memory (chosen once per launch).
//   * Work that follows the live rows: the mask phase and the successor
//     build loop over `count` rows, the prune over the valid successor
//     rows, never over F or the successor cap.
//   * A prune whose work grows with the rows, not their square.  The
//     all-pairs rule only ever drops row i in favour of a row j with the
//     SAME (p, window, state): j's crash mask a strict subset of i's, or
//     equal with j < i.  Rows are grouped by that key in a shared hash
//     table (linear probing, exact key compares), each group chained
//     through a link array, and the rule is tested only inside a group.
//     The kept set is the all-pairs kept set by construction, and the
//     compaction keeps the original index order, so the output is
//     identical.
//   * No frontier copies: three frontier buffers rotate by index.  A
//     level's entry buffer is never written during the level, so the bail
//     revert is a change of index (the level-entry snapshot costs nothing).
//   * Block scans with double-buffered warp sums (one barrier each); the
//     flags every thread needs (crash lanes alive, closure progress, goal
//     found) ride on __syncthreads_or; all control scalars live in
//     registers, the same value in every thread.
//
// The window and crash masks stay packed in one uint64 each, so bit tests
// are shifts, counts are __popcll and the shift by trailing ones is
// __ffsll(~w).  A successor's model state is recomputed from (row, lane)
// when it is built.  No tensor cores: the level loop is bit tests,
// popcounts, integer compares and scans; it has no product for wgmma, and
// making one (the TPU kernel's one-hot gathers) is the detour this card
// does not need.
//
// Grid over keys (the batch of independent keys; the TPU kernel runs one
// grid program per key under jax.vmap, linearizable.py:2905-2916): block b
// runs key b's slice on key b's tables, carry and scratch, with budget,
// lvl_cap and bail shared.  Every per-key array is stacked along a leading
// key axis with a fixed stride (the return suffix table's row is rounded
// up to 16 bytes so every key's bulk copies stay aligned), and the keys'
// n_det / n_crash come from two device arrays.  A key that has nothing to
// do (finished, dead, over budget, or bailed) leaves the level loop at
// once and writes its live rows and scalars back unchanged.  There is one
// entry point: a single search launches it with B=1, which runs the
// kernel's unkeyed instantiation (KEYED = false): the same code with the
// key offsets compiled out, its table pointers in registers as a one-key
// kernel keeps them.  Keys never
// communicate, so the grid needs no synchronisation between blocks; small
// batch shapes fit several blocks on one SM (jtt_level_loop_plan reports
// the occupancy query's blocks per SM: four of 256 threads at F <= 128).
// A launch lasts as long as its slowest key, most of whose cycles go to
// the crash closure.  A block per key stays at the narrow rungs too: a
// warp per key, several keys to a block, was measured slower on the
// H100, because a key's level is a serial chain that one warp issues from
// one of an SM's four schedulers while a block issues it from all four,
// and a batch (4 to 256 keys) never outnumbers the card's schedulers
// (PERF.md, section 6).
//
// Telemetry form (TELE = true; the TPU kernel's telemetry=True build,
// pallas_level.py:90-92, :203-204, :413, :477, :500-519): the same search,
// plus a write-only int32 [TELE_ROWS, TELE_COLS] block per key, one row per
// level added at min(level, TELE_ROWS - 1), in the column order of
// jepsen_tpu_torch/obs/telemetry.py: occupancy after the closure, valid
// lanes after the level's last mask phase, 0 mask kills and 0 dedup folds
// (the kernel takes no reduced search), closure rounds, the count after
// the revert, the level's new overflow, the goal.  The block is zero on
// entry (the caller allocates it so), and a key that leaves at once writes
// nothing.  Nothing of it is read back, so the carry is the same on and
// off.  Its state stays out of the loop's registers: the row's host values
// go through a shared row that thread 0 flushes once per level, the
// expanded count is a shared atomic add in the successor build, and the
// block's pointer sits in shared memory.  TELE = false is the kernel
// without any of it.
//
// Later work, not here: a cluster of blocks over distributed shared memory
// for the widest rungs.
//
// Memory plan (plan_for): four regions -- the frontier (three buffers of F
// rows plus per-row lane masks), the tables, the successor block (4F rows)
// and the prune's hash table -- go to dynamic shared memory in that order
// while they fit, the rest to a scratch buffer in device memory that the
// caller allocates (jtt_level_loop_plan gives its size).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (jepsen_tpu_torch/_build.py).  Plain C interface,
// loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#define MAXF 2048                // widest frontier the kernel takes
#define TELE_ROWS 128            // telemetry block: rows (levels)
#define TELE_COLS 8              //   and columns, as obs/telemetry.py
enum { C_OCC, C_EXP, C_KILL, C_DEDUP, C_ROUNDS, C_NEXT, C_OVF, C_GOAL };
#define MAXT 1024                // most threads per block
#define FULL 0xffffffffu
#define INF32 0x7fffffff
#define NIL ((int)0x80000000)

typedef unsigned long long u64;
typedef unsigned int u32;

// one configuration: window and crash masks packed, p, model state
template <int SW>
struct Row {
  u64 win;
  u64 cr;
  int p;
  int st[SW];
};

struct Tables {
  const int *det_f, *det_v1, *det_v2, *det_inv, *det_ret, *sfx;
  const int *crash_f, *crash_v1, *crash_v2, *crash_inv;
};

struct Dims {
  int F, W, NC, n_det_pad, budget, lvl_cap, bail, kid;
};

// this block's key's n_det and n_crash (set at launch from Keys)
__shared__ int key_n[2];

// telemetry form only: the level's row before its flush, and this key's
// block
__shared__ int tele_row[TELE_COLS];
__shared__ int* tele_blk;

// the key axis: key b's tables start b * n_det_pad (det), b * sfx (the
// return suffix table) and b * NC (crash) entries after key 0's; n_det /
// n_crash per key
struct Keys {
  int sfx;
  const int* n_det;
  const int* n_crash;
};

enum { R_FRONT, R_TABLES, R_SUCC, R_HASH, N_REGIONS };

struct Plan {
  long long off[N_REGIONS];  // byte offset of each region in its space
  int in_smem;               // bit r: region r lies in shared memory
  int smem_bytes;            // dynamic shared memory of the launch
  long long scratch_bytes;   // device-memory scratch the launch needs
  int threads;
  int tmax;                  // hash table slots (power of two >= 8F, 32)
};

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------

// The model step (register 0, cas-register 1, mutex 2, noop 3), the same
// semantics as jepsen_tpu_torch/models.py's tstep.
template <int SW>
__device__ __forceinline__ bool model_step(int kid, const int* st, int f,
                                           int v1, int v2, int* out) {
#pragma unroll
  for (int i = 0; i < SW; ++i) out[i] = st[i];
  int val = st[0];
  switch (kid) {
    case 0: {
      out[0] = (f == 1) ? v1 : val;
      return f == 0 ? (v1 == NIL || v1 == val) : true;
    }
    case 1: {
      bool cas_legal = v1 == val;
      out[0] = (f == 1) ? v1 : ((f == 2 && cas_legal) ? v2 : val);
      return f == 0 ? (v1 == NIL || v1 == val) : (f == 2 ? cas_legal : true);
    }
    case 2: {
      bool legal = (f == 0) ? (val == 0) : (val == 1);
      out[0] = legal ? (f == 0 ? 1 : 0) : val;
      return legal;
    }
    default:
      return true;
  }
}

// Exclusive prefix sum of one int per thread over the block; `total` gets
// the block sum.  Every thread must call it.  `wsum` alternates between
// two buffers from call to call, so one barrier suffices: the next call
// that writes the same buffer is behind the other buffer's barrier.
__device__ __forceinline__ int block_scan(int v, int* wsum, int& total) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  int s = lane < nw ? wsum[lane] : 0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(FULL, s, o);
    if (lane >= o) s += y;
  }
  total = __shfl_sync(FULL, s, nw - 1);
  int before = __shfl_sync(FULL, s, (warp + 31) & 31);
  return (warp ? before : 0) + x - v;
}

__device__ __forceinline__ void warp_argmin(int& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    int ov = __shfl_xor_sync(FULL, v, o);
    int oi = __shfl_xor_sync(FULL, i, o);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ u32 rotl32(u32 x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ u32 hash_mix(u32 h, u32 k) {
  k *= 0xcc9e2d51u;
  k = rotl32(k, 15);
  k *= 0x1b873593u;
  h ^= k;
  h = rotl32(h, 13);
  return h * 5u + 0xe6546b64u;
}

// hash of the prune key (p, window, state); the crash mask is not in it
template <int SW>
__device__ __forceinline__ u32 key_hash(const Row<SW>& R) {
  u32 h = hash_mix(0x9e3779b1u, (u32)R.p);
  h = hash_mix(h, (u32)R.win);
  h = hash_mix(h, (u32)(R.win >> 32));
#pragma unroll
  for (int s = 0; s < SW; ++s) h = hash_mix(h, (u32)R.st[s]);
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  return h ^ (h >> 16);
}

template <int SW>
__device__ __forceinline__ bool same_key(const Row<SW>& A, const Row<SW>& B) {
  bool eq = A.p == B.p && A.win == B.win;
#pragma unroll
  for (int s = 0; s < SW; ++s) eq &= A.st[s] == B.st[s];
  return eq;
}

// rows [0, nA) of the prune come from A, rows [nA, n) from B
template <int SW>
__device__ __forceinline__ const Row<SW>& row_at(const Row<SW>* A, int nA,
                                                 const Row<SW>* B, int i) {
  return i < nA ? A[i] : B[i - nA];
}

__device__ __forceinline__ int other_buf(int e, int c) {
  return e == c ? (e + 1) % 3 : 3 - e - c;
}

// ---------------------------------------------------------------------------
// phases
// ---------------------------------------------------------------------------

// Mask phase over the live rows, one warp per row: enabled det lanes from
// the window's minimum return (lowest lane on ties), the second minimum
// excluding only that lane and the suffix minimum at min(p + W, n_det);
// enabled crash lanes; the model step on each; the goal test (det lane:
// remaining <= 1, crash lane: remaining <= 0).  Every table load of a row
// is issued before the warp's reductions, so none waits on another.
// Writes vdet/vcr; ORs a goal into `found` and live crash lanes into
// `crash_any` (per thread; the caller reduces).
template <int SW>
__device__ void mask_phase(const Row<SW>* cur, int count, u64* vdet,
                           u64* vcr, const Tables& t, const Dims& d,
                           bool& found, bool& crash_any) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int nw = blockDim.x >> 5;
  for (int r = warp; r < count; r += nw) {
    const Row<SW> R = cur[r];
    int p = R.p;
    int ret[2], inv[2], df[2], dv1[2], dv2[2];
    bool open[2];
    int cinv[2], cf[2], cv1[2], cv2[2];
    bool copen[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int l = lane + 32 * h;
      int pos = p + l;
      open[h] = l < d.W && pos < key_n[0] && !((R.win >> l) & 1ull);
      ret[h] = open[h] ? t.det_ret[pos] : INF32;
      inv[h] = open[h] ? t.det_inv[pos] : INF32;
      df[h] = open[h] ? t.det_f[pos] : 0;
      dv1[h] = open[h] ? t.det_v1[pos] : 0;
      dv2[h] = open[h] ? t.det_v2[pos] : 0;
      copen[h] = l < d.NC && l < key_n[1] && !((R.cr >> l) & 1ull);
      cinv[h] = copen[h] ? t.crash_inv[l] : INF32;
      cf[h] = copen[h] ? t.crash_f[l] : 0;
      cv1[h] = copen[h] ? t.crash_v1[l] : 0;
      cv2[h] = copen[h] ? t.crash_v2[l] : 0;
    }
    int sfx = t.sfx[min(p + d.W, key_n[0])];
    int best = INF32, bidx = 1 << 20;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int l = lane + 32 * h;
      if (l < d.W && (ret[h] < best || (ret[h] == best && l < bidx))) {
        best = ret[h];
        bidx = l;
      }
    }
    warp_argmin(best, bidx);
    int m1 = best, am = bidx;
    int m2 = INF32;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int l = lane + 32 * h;
      if (l < d.W && l != am) m2 = min(m2, ret[h]);
    }
    m2 = warp_min(m2);
    int m1_tot = min(m1, sfx);
    u64 dbits = 0, cbits = 0;
    int ns[SW];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int l = lane + 32 * h;
      bool valid = open[h] && inv[h] < min(l == am ? m2 : m1, sfx) &&
                   model_step<SW>(d.kid, R.st, df[h], dv1[h], dv2[h], ns);
      dbits |= (u64)__ballot_sync(FULL, valid) << (32 * h);
      valid = copen[h] && cinv[h] < m1_tot &&
              model_step<SW>(d.kid, R.st, cf[h], cv1[h], cv2[h], ns);
      cbits |= (u64)__ballot_sync(FULL, valid) << (32 * h);
    }
    if (lane == 0) {
      vdet[r] = dbits;
      vcr[r] = cbits;
    }
    int remaining = key_n[0] - (p + __popcll(R.win));
    found |= (dbits && remaining <= 1) || (cbits && remaining <= 0);
    crash_any |= cbits != 0ull;
  }
}

// Successors of the live rows' valid det (det=true) or crash lanes, in
// row-major, lane-ascending order, the first `cap` of them into `succ`.
// Each thread takes a contiguous run of rows; one block scan places its
// successors.  Returns the uncapped total.  With `maxp`, also folds the
// rows' largest p into *maxp.  EXPANDED (the det call of the telemetry
// form) also adds the rows' valid det and crash lanes -- vmask is vdet, and
// vcr follows it at F -- into tele_row[C_EXP].
template <int SW, bool EXPANDED = false>
__device__ int build_succ(const Row<SW>* cur, int count, const u64* vmask,
                          bool det, Row<SW>* succ, int cap, const Tables& t,
                          const Dims& d, int* wsum, int* maxp) {
  int nt = blockDim.x;
  int per = (count + nt - 1) / nt;
  int r0 = threadIdx.x * per, r1 = min(r0 + per, count);
  int n = 0, mp = 0;
  for (int r = r0; r < r1; ++r) {
    n += __popcll(vmask[r]);
    if (maxp) mp = max(mp, cur[r].p);
  }
  if (EXPANDED) {
    int e = n;
    for (int r = r0; r < r1; ++r) e += __popcll(vmask[d.F + r]);
    e = (int)__reduce_add_sync(FULL, (unsigned)e);
    if ((threadIdx.x & 31) == 0 && e) atomicAdd(&tele_row[C_EXP], e);
  }
  if (maxp) {
    mp = warp_max(mp);
    if ((threadIdx.x & 31) == 0 && mp > 0) atomicMax(maxp, mp);
  }
  int total;
  int idx = block_scan(n, wsum, total);
  for (int r = r0; r < r1 && idx < cap; ++r) {
    u64 bits = vmask[r];
    if (!bits) continue;
    const Row<SW> R = cur[r];
    while (bits && idx < cap) {
      int l = __ffsll((long long)bits) - 1;
      bits &= bits - 1ull;
      Row<SW> S;
      int f, v1, v2;
      if (det) {
        int pos = R.p + l;
        f = t.det_f[pos];
        v1 = t.det_v1[pos];
        v2 = t.det_v2[pos];
        u64 w1 = R.win | (1ull << l);
        // advance p over the run of linearized ops at the window's start
        int shift = (~w1 == 0ull) ? 64 : __ffsll((long long)~w1) - 1;
        S.win = shift >= 64 ? 0ull : (w1 >> shift);
        S.p = R.p + shift;
        S.cr = R.cr;
      } else {
        f = t.crash_f[l];
        v1 = t.crash_v1[l];
        v2 = t.crash_v2[l];
        S.win = R.win;
        S.p = R.p;
        S.cr = R.cr | (1ull << l);
      }
      model_step<SW>(d.kid, R.st, f, v1, v2, S.st);
      succ[idx++] = S;
    }
  }
  return total;
}

struct Hash {
  int* head;  // per slot: the group's key row, or -1
  int* chain; // per slot: the group's last member, or -1
  int* link;  // per row: the group's previous member, or -1
  int* slot;  // per row: its group's slot
};

// Exact all-pairs dominance prune over rows [0, n) (rows [0, nA) from A,
// the rest from B), then compaction of the first F kept rows, in order,
// into `out`.  Row i is dropped when a valid row j has the same (p,
// window, state) and j's crash mask is a strict subset of i's, or is
// equal with j < i; only rows of one key group are compared.  Returns the
// kept count (uncapped).  The closing barrier ORs `flag` -- or, when
// `progress` is set, whether a kept row lies at index >= nA -- into
// *any.  The hash table is all -1 on entry and on return.
template <int SW>
__device__ int prune_compact(const Row<SW>* A, int nA, const Row<SW>* B,
                             int n, Row<SW>* out, int F, const Hash& hs,
                             int tsize, int* wsum, bool progress, bool flag,
                             int* any) {
  int tid = threadIdx.x, nt = blockDim.x;
  __syncthreads();  // the rows are written
  for (int i = tid; i < n; i += nt) {
    const Row<SW>& R = row_at(A, nA, B, i);
    int h = (int)(key_hash(R) & (u32)(tsize - 1));
    while (true) {
      int r = atomicCAS(&hs.head[h], -1, i);
      if (r < 0 || same_key(row_at(A, nA, B, r), R)) break;
      h = (h + 1) & (tsize - 1);
    }
    hs.link[i] = atomicExch(&hs.chain[h], i);
    hs.slot[i] = h;
  }
  __syncthreads();
  int per = (n + nt - 1) / nt;  // <= 32: n <= 4F <= 32 * threads
  int r0 = tid * per, r1 = min(r0 + per, n);
  u32 kept = 0;
  for (int i = r0; i < r1; ++i) {
    u64 cri = row_at(A, nA, B, i).cr;
    bool keep = true;
    for (int j = hs.chain[hs.slot[i]]; j >= 0 && keep; j = hs.link[j]) {
      if (j == i) continue;
      u64 crj = row_at(A, nA, B, j).cr;
      if ((crj != cri && (crj & ~cri) == 0ull) || (crj == cri && j < i))
        keep = false;
    }
    if (keep) kept |= 1u << (i - r0);
  }
  int nk;
  int rank = block_scan(__popc(kept), wsum, nk);
  bool prog = false;
  for (int i = r0; i < r1; ++i) {
    if (!((kept >> (i - r0)) & 1u)) continue;
    if (rank < F) out[rank] = row_at(A, nA, B, i);
    ++rank;
    prog |= i >= nA;
  }
  // leave the table empty for the next prune: every slot that was taken
  // is the slot of some row
  for (int i = tid; i < n; i += nt) {
    int h = hs.slot[i];
    hs.head[h] = -1;
    hs.chain[h] = -1;
  }
  *any = __syncthreads_or(progress ? prog : flag);
  return nk;
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

__device__ __forceinline__ u32 smem_addr(const void* p) {
  return (u32)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         u32 bytes, u64* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <int SW, bool KEYED, bool TELE>
__global__ void __launch_bounds__(MAXT)
level_loop_kernel(Tables tg, Dims d, Plan pl, Keys ks,
                  const int* __restrict__ fin,
                  const int* __restrict__ scal_in, int* __restrict__ fout,
                  int* __restrict__ scal_out, unsigned char* scratch,
                  int* __restrict__ tele) {
  extern __shared__ __align__(128) unsigned char dsm[];
  __shared__ __align__(8) u64 tma_bar;
  __shared__ int wsum[2][32];
  __shared__ int maxp[2];
  __shared__ Tables st;

  const int tid = threadIdx.x, nt = blockDim.x;
  const int F = d.F, WW = d.W / 32, CW = d.NC / 32;
  const int WORDS = 1 + WW + CW + SW, SCAP = 4 * F;

  // this block's key: its tables, carry, scalars and scratch.  Nothing of
  // the key stays in registers across the level loop: fout and scal_out
  // are offset where they are written, and in the keyed form the table
  // pointers (st) and counts (key_n) sit in shared memory.  Held in
  // registers, they pushed the loop past the 64 registers a 1024-thread
  // block allows, and the spills slowed every level
  const long long b = KEYED ? blockIdx.x : 0;
  if (KEYED) {
    tg.det_f += b * d.n_det_pad;
    tg.det_v1 += b * d.n_det_pad;
    tg.det_v2 += b * d.n_det_pad;
    tg.det_inv += b * d.n_det_pad;
    tg.det_ret += b * d.n_det_pad;
    tg.sfx += b * ks.sfx;
    tg.crash_f += b * d.NC;
    tg.crash_v1 += b * d.NC;
    tg.crash_v2 += b * d.NC;
    tg.crash_inv += b * d.NC;
  }
  if (tid == 0) {
    key_n[0] = ks.n_det[b];
    key_n[1] = ks.n_crash[b];
  }
  fin += b * F * WORDS;
  scal_in += 5 * b;
  scratch += b * pl.scratch_bytes;

  // a key with nothing to do (a pad lane, a finished key) hands its
  // frontier and scalars back as they came, before any table is read
  if (!(scal_in[1] == -1 && scal_in[0] > 0 && scal_in[2] < d.budget &&
        !(d.bail && scal_in[4]))) {
    for (int i = tid; i < F * WORDS; i += nt) fout[b * F * WORDS + i] = fin[i];
    if (tid < 5)
      scal_out[5 * b + tid] = tid == 4 ? scal_in[4] != 0 : scal_in[tid];
    return;
  }
  unsigned char* base[N_REGIONS];
#pragma unroll
  for (int r = 0; r < N_REGIONS; ++r)
    base[r] = ((pl.in_smem >> r) & 1 ? dsm : scratch) + pl.off[r];

  Row<SW>* buf[3];
  buf[0] = (Row<SW>*)base[R_FRONT];
  buf[1] = buf[0] + F;
  buf[2] = buf[1] + F;
  u64* vdet = (u64*)(buf[2] + F);
  u64* vcr = vdet + F;
  Row<SW>* succ = (Row<SW>*)base[R_SUCC];
  Hash hs;
  hs.head = (int*)base[R_HASH];
  hs.chain = hs.head + pl.tmax;
  hs.link = hs.chain + pl.tmax;
  hs.slot = hs.link + SCAP;

  const bool tables_smem = (pl.in_smem >> R_TABLES) & 1;
  Tables t = tg;
  if (tables_smem) {
    const int nd = d.n_det_pad, nc = d.NC;
    int* s = (int*)base[R_TABLES];
    int* sfx = s + 5 * nd;
    int* cr = sfx + nd + 4;
    t = Tables{s, s + nd, s + 2 * nd, s + 3 * nd, s + 4 * nd, sfx,
               cr, cr + nc, cr + 2 * nc, cr + 3 * nc};
    if (tid == 0) {
      // ten bulk copies on one mbarrier: the five det tables, sfx's first
      // n_det_pad entries (its last one is not a multiple of 16 bytes
      // and goes by a plain load) and the four crash tables
      u32 det_b = (u32)nd * 4u, cr_b = (u32)nc * 4u;
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_addr(&tma_bar)),
                   "r"(1u)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              smem_addr(&tma_bar)),
          "r"(6u * det_b + 4u * cr_b)
          : "memory");
      const int* src[10] = {tg.det_f,   tg.det_v1,   tg.det_v2, tg.det_inv,
                            tg.det_ret, tg.sfx,      tg.crash_f,
                            tg.crash_v1, tg.crash_v2, tg.crash_inv};
      const int* dst[10] = {t.det_f,   t.det_v1,   t.det_v2, t.det_inv,
                            t.det_ret, t.sfx,      t.crash_f,
                            t.crash_v1, t.crash_v2, t.crash_inv};
#pragma unroll
      for (int k = 0; k < 10; ++k)
        bulk_g2s((void*)dst[k], src[k], k < 6 ? det_b : cr_b, &tma_bar);
      sfx[nd] = tg.sfx[nd];
    }
  }

  if (KEYED && tid == 0) st = t;
  const Tables& tk = KEYED ? st : t;

  // the carry, while the tables are in flight
  int count = scal_in[0];
  int status = scal_in[1];
  int configs = scal_in[2];
  int md = scal_in[3];
  bool ovf = scal_in[4] != 0;
  count = min(count, F);
  for (int r = tid; r < count; r += nt) {
    const int* w = fin + (size_t)r * WORDS;
    Row<SW> R;
    R.p = w[0];
    R.win = (u64)(unsigned)w[1];
    if (WW == 2) R.win |= (u64)(unsigned)w[2] << 32;
    const int* cw = w + 1 + WW;
    R.cr = (u64)(unsigned)cw[0];
    if (CW == 2) R.cr |= (u64)(unsigned)cw[1] << 32;
#pragma unroll
    for (int s = 0; s < SW; ++s) R.st[s] = cw[CW + s];
    buf[0][r] = R;
  }
  for (int s = tid; s < pl.tmax; s += nt) hs.head[s] = hs.chain[s] = -1;
  if (tid == 0) maxp[0] = maxp[1] = 0;
  if (TELE && tid < TELE_COLS) {
    tele_row[tid] = 0;
    if (tid == 0) tele_blk = tele + b * TELE_ROWS * TELE_COLS;
  }
  __syncthreads();
  if (tables_smem) {
    u32 done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(smem_addr(&tma_bar)), "r"(0u)
          : "memory");
    }
  }

  int c = 0;    // the current frontier buffer
  int ph = 0;   // scan buffer parity
  int mph = 0;  // maxp parity
  int any;
  for (int lvl = 0; lvl < d.lvl_cap; ++lvl) {
    if (!(status == -1 && count > 0 && configs < d.budget &&
          !(d.bail && ovf)))
      break;
    // level entry: buffer e is not written during the level, so the
    // snapshot for a bail revert is (e, the entry scalars)
    const int e = c, cnt0 = count, cfg0 = configs, md0 = md;
    const bool ovf0 = ovf;
    bool found = false, crash = false;
    mask_phase<SW>(buf[c], count, vdet, vcr, tk, d, found, crash);
    bool go = __syncthreads_or(crash);
    // every thread is past the last level's read of maxp[mph ^ 1]
    if (tid == 0) maxp[mph ^ 1] = 0;

    // crash closure: at most n_crash + 1 rounds while successors survive
    bool progress = false;
    int rounds = 0;
    while (go) {
      int total = build_succ<SW>(buf[c], count, vcr, false, succ, F, tk, d,
                                 wsum[ph], nullptr);
      ph ^= 1;
      if (total > F) ovf = true;
      int ns = min(total, F);
      int o = other_buf(e, c);
      int tsize = max(32, 1 << (32 - __clz(2 * (count + ns) - 1)));
      int nk = prune_compact<SW>(buf[c], count, succ, count + ns, buf[o], F,
                                 hs, tsize, wsum[ph], true, false, &any);
      ph ^= 1;
      progress = any;
      if (nk > F) ovf = true;
      count = min(nk, F);
      c = o;
      crash = false;
      mask_phase<SW>(buf[c], count, vdet, vcr, tk, d, found, crash);
      bool crash_any = __syncthreads_or(crash);
      ++rounds;
      go = rounds < key_n[1] + 1 && progress;
      if (go && !crash_any) {
        // the next round would merge an empty successor block into an
        // already pruned frontier: it keeps every row and ends with no
        // progress, so take its outcome without running it.  The TPU
        // kernel and the torch step run and count such a round, so the
        // telemetry counts it.  It does not arise, though: a row with an
        // enabled crash lane is dropped only for a row of the same key
        // with a smaller crash mask, which has every lane it has, and
        // kept rows of the level come before any successor, so the F
        // cap never cuts them: some kept row keeps an enabled lane
        progress = false;
        go = false;
        if (TELE) ++rounds;
      }
    }
    // leaving by the round cap while still adding rows: not proven
    // closed, which degrades like an overflow
    if (progress) ovf = true;
    if (TELE && tid == 0) {
      tele_row[C_OCC] = count;
      tele_row[C_ROUNDS] = rounds;
    }

    // determinate successors into the next level
    int total = build_succ<SW, TELE>(buf[c], count, vdet, true, succ, SCAP,
                                     tk, d, wsum[ph], &maxp[mph]);
    ph ^= 1;
    if (total > SCAP) ovf = true;
    int ns = min(total, SCAP);
    int o = other_buf(e, c);
    int tsize = max(32, 1 << (32 - __clz(2 * max(ns, 1) - 1)));
    int nk = prune_compact<SW>(succ, ns, nullptr, ns, buf[o], F, hs, tsize,
                               wsum[ph], false, found, &any);
    ph ^= 1;
    found = any;
    if (nk > F) ovf = true;
    configs += count;
    md = max(md, maxp[mph]);
    mph ^= 1;
    if (found) status = 2;
    // uncommit an overflowing level when a wider re-run is coming and no
    // goal was found
    if (d.bail && ovf && !ovf0 && !found) {
      count = cnt0;
      configs = cfg0;
      md = md0;
      c = e;
    } else {
      count = min(nk, F);
      c = o;
    }
    if (TELE && tid == 0) {
      // the level's row; tele_row[C_EXP] is complete: the successor
      // build's adds are behind the prune's barriers
      int* row = tele_blk + min(lvl, TELE_ROWS - 1) * TELE_COLS;
      row[C_OCC] += tele_row[C_OCC];
      row[C_EXP] += tele_row[C_EXP];
      row[C_ROUNDS] += tele_row[C_ROUNDS];
      row[C_NEXT] += count;
      row[C_OVF] += ovf && !ovf0;
      row[C_GOAL] += found;
      tele_row[C_EXP] = 0;
    }
  }

  const Row<SW>* cur = buf[c];
  const long long bo = KEYED ? blockIdx.x : 0;
  fout += bo * F * WORDS;
  scal_out += 5 * bo;
  for (int r = tid; r < F; r += nt) {
    int* w = fout + (size_t)r * WORDS;
    int* cw = w + 1 + WW;
    if (r < count) {
      const Row<SW> R = cur[r];
      w[0] = R.p;
      w[1] = (int)(unsigned)(R.win & 0xffffffffull);
      if (WW == 2) w[2] = (int)(unsigned)(R.win >> 32);
      cw[0] = (int)(unsigned)(R.cr & 0xffffffffull);
      if (CW == 2) cw[1] = (int)(unsigned)(R.cr >> 32);
#pragma unroll
      for (int s = 0; s < SW; ++s) cw[CW + s] = R.st[s];
    } else {
      for (int k = 0; k < WORDS; ++k) w[k] = 0;
    }
  }
  if (tid == 0) {
    scal_out[0] = count;
    scal_out[1] = status;
    scal_out[2] = configs;
    scal_out[3] = md;
    scal_out[4] = ovf;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// cudaFuncSetAttribute sets a limit of the function itself, which each
// later launch or occupancy query of it is checked against.  Keys checked
// in parallel threads launch one instantiation at plans of different
// shared memory, so each set-then-use pair holds this lock: otherwise a
// launch may meet the smaller limit another thread set in between, and
// fail.  A launch only enqueues, so the lock is held briefly.
static std::mutex attr_lock;

static long long round16(long long x) { return (x + 15) & ~15ll; }

static int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

static bool dims_ok(int F, int W, int NC, int SW, int n_det_pad) {
  return F >= 1 && F <= MAXF && (W == 32 || W == 64) &&
         (NC == 32 || NC == 64) && SW >= 1 && SW <= 4 && n_det_pad >= 16 &&
         n_det_pad % 4 == 0;
}

template <int SW, bool TELE>
static int plan_sw(int F, int NC, int n_det_pad, Plan* pl) {
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncGetAttributes(&attr, level_loop_kernel<SW, true, TELE>);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, optin = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  long long rb = (long long)sizeof(Row<SW>);
  pl->tmax = next_pow2(8 * F < 32 ? 32 : 8 * F);
  long long size[N_REGIONS] = {
      round16(3 * F * rb) + round16(16ll * F),
      6ll * 4 * n_det_pad + 16 + 4ll * 4 * NC,
      round16(4 * F * rb),
      round16(4ll * (2ll * pl->tmax + 8ll * F)),
  };
  long long room = (long long)optin - (long long)attr.sharedSizeBytes;
  long long smem = 0, scratch = 0;
  pl->in_smem = 0;
  for (int r = 0; r < N_REGIONS; ++r) {
    if (smem + size[r] <= room) {
      pl->in_smem |= 1 << r;
      pl->off[r] = smem;
      smem += size[r];
    } else {
      pl->off[r] = scratch;
      scratch += size[r];
    }
  }
  pl->smem_bytes = (int)smem;
  pl->scratch_bytes = scratch;
  int threads = (2 * F + 31) / 32 * 32;
  pl->threads = threads < 256 ? 256 : (threads > MAXT ? MAXT : threads);
  return 0;
}

// blocks of this plan that fit one SM at once (the occupancy query,
// for the keyed form: the grid's blocks)
template <int SW, bool TELE>
static int occupancy_sw(const Plan& pl, int* blocks) {
  std::lock_guard<std::mutex> hold(attr_lock);
  cudaError_t err = cudaFuncSetAttribute(
      level_loop_kernel<SW, true, TELE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, level_loop_kernel<SW, true, TELE>, pl.threads, pl.smem_bytes);
}

template <bool TELE>
static int plan_for(int F, int NC, int SW, int n_det_pad, Plan* pl) {
  switch (SW) {
    case 1: return plan_sw<1, TELE>(F, NC, n_det_pad, pl);
    case 2: return plan_sw<2, TELE>(F, NC, n_det_pad, pl);
    case 3: return plan_sw<3, TELE>(F, NC, n_det_pad, pl);
    default: return plan_sw<4, TELE>(F, NC, n_det_pad, pl);
  }
}

// the plan of the off (tele = 0) or telemetry form: their static shared
// memory differs by the telemetry row
static int plan_for(int F, int NC, int SW, int n_det_pad, int tele,
                    Plan* pl) {
  return tele ? plan_for<true>(F, NC, SW, n_det_pad, pl)
              : plan_for<false>(F, NC, SW, n_det_pad, pl);
}

template <bool TELE>
static int occupancy_for(int SW, const Plan& pl, int* blocks) {
  switch (SW) {
    case 1: return occupancy_sw<1, TELE>(pl, blocks);
    case 2: return occupancy_sw<2, TELE>(pl, blocks);
    case 3: return occupancy_sw<3, TELE>(pl, blocks);
    default: return occupancy_sw<4, TELE>(pl, blocks);
  }
}

template <int SW>
static int launch_sw(int B, const Tables& t, const Dims& d, const Plan& pl,
                     const Keys& ks, const int* fin, const int* scal_in,
                     int* fout, int* scal_out, unsigned char* scratch,
                     int* tele, cudaStream_t stream) {
  // one key: the unkeyed instantiation (see the head of this file); a
  // telemetry block: the telemetry form
  auto kernel = tele ? (B > 1 ? level_loop_kernel<SW, true, true>
                              : level_loop_kernel<SW, false, true>)
                     : (B > 1 ? level_loop_kernel<SW, true, false>
                              : level_loop_kernel<SW, false, false>);
  std::lock_guard<std::mutex> hold(attr_lock);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, pl.threads, pl.smem_bytes, stream>>>(
      t, d, pl, ks, fin, scal_in, fout, scal_out, scratch, tele);
  return (int)cudaGetLastError();
}

// The launch's checks, then one launch of B blocks.
static int launch(int B, const Tables& t, const Keys& ks, const int* fin,
                  const int* scal_in, int* fout, int* scal_out,
                  void* scratch, long long scratch_bytes, int F, int W,
                  int NC, int SW, int n_det_pad, int budget, int lvl_cap,
                  int bail, int kid, int* tele, void* stream) {
  if (B < 1 || !dims_ok(F, W, NC, SW, n_det_pad) || !ks.n_det ||
      !ks.n_crash || ks.sfx < n_det_pad + 1 || (B > 1 && ks.sfx % 4))
    return (int)cudaErrorInvalidValue;
  const int* ptrs[10] = {t.det_f,   t.det_v1,   t.det_v2,   t.det_inv,
                         t.det_ret, t.sfx,      t.crash_f,  t.crash_v1,
                         t.crash_v2, t.crash_inv};
  for (int k = 0; k < 10; ++k)
    if ((uintptr_t)ptrs[k] % 16) return (int)cudaErrorMisalignedAddress;
  Plan pl;
  int rc = plan_for(F, NC, SW, n_det_pad, tele != nullptr, &pl);
  if (rc) return rc;
  if (scratch_bytes < (long long)B * pl.scratch_bytes)
    return (int)cudaErrorInvalidValue;
  Dims d = {F, W, NC, n_det_pad, budget, lvl_cap, bail, kid};
  unsigned char* s = (unsigned char*)scratch;
  cudaStream_t st = (cudaStream_t)stream;
  switch (SW) {
    case 1: return launch_sw<1>(B, t, d, pl, ks, fin, scal_in, fout, scal_out, s, tele, st);
    case 2: return launch_sw<2>(B, t, d, pl, ks, fin, scal_in, fout, scal_out, s, tele, st);
    case 3: return launch_sw<3>(B, t, d, pl, ks, fin, scal_in, fout, scal_out, s, tele, st);
    default: return launch_sw<4>(B, t, d, pl, ks, fin, scal_in, fout, scal_out, s, tele, st);
  }
}

extern "C" {

// The launch plan for these dims on the current device, of the off form
// (tele = 0) or the telemetry form: out[0] dynamic shared bytes, out[1] the
// regions in shared memory (bit 0 frontier, 1 tables, 2 successor block,
// 3 hash table), out[2] threads, out[3] scratch bytes the caller must
// allocate per key, out[4] blocks of the plan that fit one SM at once.
// Returns a CUDA error code.
int jtt_level_loop_plan(int F, int W, int NC, int SW, int n_det_pad,
                        int tele, long long* out) {
  if (!dims_ok(F, W, NC, SW, n_det_pad)) return (int)cudaErrorInvalidValue;
  Plan pl;
  int rc = plan_for(F, NC, SW, n_det_pad, tele, &pl);
  if (rc) return rc;
  int blocks = 0;
  rc = tele ? occupancy_for<true>(SW, pl, &blocks)
            : occupancy_for<false>(SW, pl, &blocks);
  if (rc) return rc;
  out[0] = pl.smem_bytes;
  out[1] = pl.in_smem;
  out[2] = pl.threads;
  out[3] = pl.scratch_bytes;
  out[4] = blocks;
  return 0;
}

// Launch one slice of B keys on `stream`, one block per key (a single
// search: B = 1).  Tables are [B, n_det_pad] (det), [B, sfx_stride] (the
// return suffix table, stride > n_det_pad and, for B > 1, a multiple of 4)
// and [B, NC] (crash), every one 16-byte aligned (the bulk copies need
// it); frontiers [B, F, words]; scalars [B, 5]; n_det and n_crash [B]
// int32 on the device; `scratch` holds B times the plan's scratch bytes
// (the plan of the form launched).  `tele` null launches the off form;
// else the telemetry form adds each key's rows into tele [B, TELE_ROWS,
// TELE_COLS], which the caller zeroes.  Returns cudaGetLastError() after
// the launch (0 on success); does not synchronise.
int jtt_level_loop(const int* det_f, const int* det_v1, const int* det_v2,
                   const int* det_inv, const int* det_ret, const int* sfx,
                   const int* crash_f, const int* crash_v1,
                   const int* crash_v2, const int* crash_inv, int sfx_stride,
                   const int* n_det, const int* n_crash,
                   const int* frontier_in, const int* scal_in,
                   int* frontier_out, int* scal_out, void* scratch,
                   long long scratch_bytes, int B, int F, int W, int NC,
                   int SW, int n_det_pad, int budget, int lvl_cap, int bail,
                   int kid, void* stream, int* tele) {
  Tables t = {det_f, det_v1, det_v2, det_inv, det_ret, sfx,
              crash_f, crash_v1, crash_v2, crash_inv};
  Keys ks = {sfx_stride, n_det, n_crash};
  return launch(B, t, ks, frontier_in, scal_in, frontier_out, scal_out,
                scratch, scratch_bytes, F, W, NC, SW, n_det_pad, budget,
                lvl_cap, bail, kid, tele, stream);
}

const char* jtt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
