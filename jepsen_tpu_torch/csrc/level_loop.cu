// Fused BFS level loop of the linearizability search, for Hopper (sm_90a).
//
// Replaces jepsen_tpu/checker/pallas_level.py::build_pallas_step_fn (the
// Pallas TPU kernel).  One launch runs one slice of one search: up to
// lvl_cap levels of mask phase -> crash closure -> determinate successors
// -> exact all-pairs dominance prune -> compaction, with the frontier held
// in shared memory, and returns the packed carry.  It computes bit for bit
// what jepsen_tpu_torch/checker/step.py computes with the all-pairs prune:
// same survivor order (row-major, lane-ascending), same configs, same
// overflow / bail / revert behaviour.
//
// What bounds it: serial per-level latency on one SM.  A level is a chain
// of dependent phases separated by __syncthreads over at most 256 rows; a
// slice moves its tables and carry once (tens of KB) and does at most a
// few hundred thousand integer compares per level, far below the card's
// byte or operation rates.  The design keeps every level inside one block
// (no launches, no device-memory round trips between levels) and keeps the
// window and crash masks packed in one uint64 each, so bit tests are
// shifts, counts are __popcll and the shift by trailing ones is
// __ffsll(~w).  History tables are read straight from device memory
// by absolute index (they are a few KB and stay in L2).  Compaction is warp
// __ballot_sync + __popc with a block-level exclusive scan in shared
// memory, which keeps the row-major, lane-ascending order exactly.  A
// successor's model state is recomputed from (row, lane) when it is built
// rather than stored per lane.
//
// Right first: no wgmma, no TMA, one block per search.  Making it fast
// (several searches per launch as a grid over keys, fewer barriers per
// level) is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (jepsen_tpu_torch/_build.py).  Plain C interface,
// loaded with ctypes.

#include <cuda_runtime.h>

#define MAXF 64                  // widest frontier the kernel takes
#define MAXM (4 * MAXF)          // det successor cap SCAP = 4F
#define NTHREADS 256             // one thread per row of the widest prune
#define NWARPS (NTHREADS / 32)
#define FULL 0xffffffffu
#define INF32 0x7fffffff
#define NIL ((int)0x80000000)

typedef unsigned long long u64;

// one configuration: window and crash masks packed, p, model state
struct Row {
  u64 win;
  u64 cr;
  int p;
  int st[4];
};

struct Tables {
  const int *det_f, *det_v1, *det_v2, *det_inv, *det_ret, *sfx;
  const int *crash_f, *crash_v1, *crash_v2, *crash_inv;
};

struct Dims {
  int F, W, NC, SW, WW, CW;
  int n_det, n_crash, budget, lvl_cap, bail, kid;
};

struct Shared {
  Row cur[MAXF];    // the live frontier
  Row snap[MAXF];   // level-entry snapshot (bail revert)
  Row nxt[MAXF];    // compaction output
  Row succ[MAXM];   // successor block
  u64 vdet[MAXF];   // valid det lanes per row (mask phase)
  u64 vcr[MAXF];    // valid crash lanes per row
  int off[MAXF];    // successor offset per row
  int wsum[NWARPS];
  int count, status, configs, md, ovf, run, found, revert, maxp;
  int cnt0, cfg0, md0, ovf0;
};

// The model step (register 0, cas-register 1, mutex 2, noop 3), the same
// semantics as jepsen_tpu_torch/models.py's tstep.
__device__ __forceinline__ bool model_step(int kid, const int* st, int f,
                                           int v1, int v2, int* out,
                                           int SW) {
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

// Exclusive prefix sum of one int per thread over the block; *total gets
// the block sum.  Every thread must call it.
__device__ int block_excl_scan(int v, int* wsum, int* total) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  int before = 0, tot = 0;
  for (int w = 0; w < NWARPS; ++w) {
    if (w < warp) before += wsum[w];
    tot += wsum[w];
  }
  __syncthreads();
  *total = tot;
  return before + x - v;
}

__device__ __forceinline__ void warp_argmin(int& v, int& i) {
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
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Mask phase over the current frontier, one warp per row: enabled det
// lanes from the window's minimum return (lowest lane on ties), the
// second minimum excluding only that lane and the suffix minimum at
// min(p + W, n_det); enabled crash lanes; the model step on each; the
// goal test (det lane: remaining <= 1, crash lane: remaining <= 0).
// Writes vdet/vcr and ORs any goal into sh.found.
__device__ void mask_phase(Shared& sh, const Tables& t, const Dims& d) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int count = sh.count;
  for (int r = warp; r < d.F; r += NWARPS) {
    if (r >= count) {
      if (lane == 0) sh.vdet[r] = sh.vcr[r] = 0;
      continue;
    }
    const Row& R = sh.cur[r];
    int p = R.p;
    int wret[2];
    int best = INF32, bidx = 1 << 20;
    for (int h = 0; h < 2; ++h) {
      int l = lane + 32 * h;
      int v = INF32;
      if (l < d.W) {
        int pos = p + l;
        if (pos < d.n_det && !((R.win >> l) & 1ull)) v = t.det_ret[pos];
        if (v < best || (v == best && l < bidx)) {
          best = v;
          bidx = l;
        }
      }
      wret[h] = v;
    }
    warp_argmin(best, bidx);
    int m1 = best, am = bidx;
    int m2 = INF32;
    for (int h = 0; h < 2; ++h) {
      int l = lane + 32 * h;
      if (l < d.W && l != am) m2 = min(m2, wret[h]);
    }
    m2 = warp_min(m2);
    int sfx = t.sfx[min(p + d.W, d.n_det)];
    int m1_tot = min(m1, sfx);
    u64 dbits = 0, cbits = 0;
    int ns[4];
    for (int h = 0; h < 2; ++h) {
      int l = lane + 32 * h;
      bool valid = false;
      if (l < d.W) {
        int pos = p + l;
        if (pos < d.n_det && !((R.win >> l) & 1ull)) {
          int excl = min(l == am ? m2 : m1, sfx);
          if (t.det_inv[pos] < excl)
            valid = model_step(d.kid, R.st, t.det_f[pos], t.det_v1[pos],
                               t.det_v2[pos], ns, d.SW);
        }
      }
      dbits |= (u64)__ballot_sync(FULL, valid) << (32 * h);
      int c = l;
      valid = false;
      if (c < d.NC && c < d.n_crash && !((R.cr >> c) & 1ull) &&
          t.crash_inv[c] < m1_tot)
        valid = model_step(d.kid, R.st, t.crash_f[c], t.crash_v1[c],
                           t.crash_v2[c], ns, d.SW);
      cbits |= (u64)__ballot_sync(FULL, valid) << (32 * h);
    }
    if (lane == 0) {
      sh.vdet[r] = dbits;
      sh.vcr[r] = cbits;
      int remaining = d.n_det - (p + __popcll(R.win));
      if ((dbits && remaining <= 1) || (cbits && remaining <= 0))
        sh.found = 1;
    }
  }
  __syncthreads();
}

// Successors of the current frontier's valid det (det=true) or crash
// lanes, in row-major, lane-ascending order, the first `cap` of them into
// sh.succ.  Returns the uncapped total.
__device__ int build_succ(Shared& sh, const Tables& t, const Dims& d,
                          bool det, int cap) {
  int tid = threadIdx.x;
  int c = 0;
  if (tid < d.F) c = __popcll(det ? sh.vdet[tid] : sh.vcr[tid]);
  int total;
  int off = block_excl_scan(c, sh.wsum, &total);
  if (tid < d.F) sh.off[tid] = off;
  __syncthreads();
  int lane = tid & 31, warp = tid >> 5;
  for (int r = warp; r < d.F; r += NWARPS) {
    u64 bits = det ? sh.vdet[r] : sh.vcr[r];
    const Row& R = sh.cur[r];
    for (int h = 0; h < 2; ++h) {
      int l = lane + 32 * h;
      if (!((bits >> l) & 1ull)) continue;
      int idx = sh.off[r] + __popcll(bits & ((1ull << l) - 1ull));
      if (idx >= cap) continue;
      Row& S = sh.succ[idx];
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
      model_step(d.kid, R.st, f, v1, v2, S.st, d.SW);
    }
  }
  __syncthreads();
  return total;
}

// Rows of the prune: the closure merges the live frontier (rows [0, F))
// with the crash successors (rows [F, 2F)); the det prune runs over the
// successor block alone.
__device__ __forceinline__ const Row& row_at(const Shared& sh, bool closure,
                                             int F, int i) {
  return closure ? (i < F ? sh.cur[i] : sh.succ[i - F]) : sh.succ[i];
}

__device__ __forceinline__ bool row_valid(const Shared& sh, bool closure,
                                          int F, int n_succ, int i) {
  if (closure) return i < F ? i < sh.count : i - F < n_succ;
  return i < n_succ;
}

// Exact all-pairs dominance prune over M rows, then compaction of the
// first F kept rows (in order) into sh.nxt.  Row i is dropped when a valid
// row j has the same (p, window, state) and j's crash mask is a strict
// subset of i's, or is equal with j < i.  Returns the kept count
// (uncapped); *progress is set when a kept row lies at index >= F.
__device__ int prune_compact(Shared& sh, const Dims& d, bool closure, int M,
                             int n_succ, int* progress) {
  int tid = threadIdx.x;
  bool kept = false;
  if (tid < M && row_valid(sh, closure, d.F, n_succ, tid)) {
    const Row& A = row_at(sh, closure, d.F, tid);
    kept = true;
    for (int j = 0; j < M && kept; ++j) {
      if (j == tid || !row_valid(sh, closure, d.F, n_succ, j)) continue;
      const Row& B = row_at(sh, closure, d.F, j);
      if (B.p != A.p || B.win != A.win) continue;
      bool same = true;
      for (int s = 0; s < d.SW; ++s) same &= A.st[s] == B.st[s];
      if (!same) continue;
      bool eq_cr = A.cr == B.cr;
      if ((!eq_cr && (B.cr & ~A.cr) == 0ull) || (eq_cr && j < tid))
        kept = false;
    }
  }
  int lane = tid & 31, warp = tid >> 5;
  unsigned b = __ballot_sync(FULL, kept);
  if (lane == 0) sh.wsum[warp] = __popc(b);
  __syncthreads();
  int before = 0, tot = 0;
  for (int w = 0; w < NWARPS; ++w) {
    if (w < warp) before += sh.wsum[w];
    tot += sh.wsum[w];
  }
  int rank = before + __popc(b & ((1u << lane) - 1u));
  if (kept && rank < d.F) sh.nxt[rank] = row_at(sh, closure, d.F, tid);
  int prog = __syncthreads_or(kept && tid >= d.F);
  if (progress) *progress = prog;
  return tot;
}

__device__ __forceinline__ Row zero_row() {
  Row z;
  z.win = z.cr = 0ull;
  z.p = 0;
  z.st[0] = z.st[1] = z.st[2] = z.st[3] = 0;
  return z;
}

__global__ void __launch_bounds__(NTHREADS)
level_loop_kernel(Tables t, Dims d, const int* __restrict__ fin,
                  const int* __restrict__ scal_in, int* __restrict__ fout,
                  int* __restrict__ scal_out) {
  __shared__ Shared sh;
  int tid = threadIdx.x;
  const int F = d.F, WORDS = 1 + d.WW + d.CW + d.SW, SCAP = 4 * d.F;
  for (int r = tid; r < F; r += NTHREADS) {
    const int* w = fin + r * WORDS;
    Row R;
    R.p = w[0];
    R.win = (u64)(unsigned)w[1];
    if (d.WW == 2) R.win |= (u64)(unsigned)w[2] << 32;
    const int* cw = w + 1 + d.WW;
    R.cr = (u64)(unsigned)cw[0];
    if (d.CW == 2) R.cr |= (u64)(unsigned)cw[1] << 32;
    for (int s = 0; s < 4; ++s) R.st[s] = s < d.SW ? cw[d.CW + s] : 0;
    sh.cur[r] = R;
  }
  if (tid == 0) {
    sh.count = scal_in[0];
    sh.status = scal_in[1];
    sh.configs = scal_in[2];
    sh.md = scal_in[3];
    sh.ovf = scal_in[4] != 0;
    sh.run = sh.status == -1 && sh.count > 0 && sh.configs < d.budget &&
             !(d.bail && sh.ovf);
  }
  __syncthreads();

  for (int lvl = 0; lvl < d.lvl_cap && sh.run; ++lvl) {
    for (int r = tid; r < F; r += NTHREADS) sh.snap[r] = sh.cur[r];
    if (tid == 0) {
      sh.cnt0 = sh.count;
      sh.cfg0 = sh.configs;
      sh.md0 = sh.md;
      sh.ovf0 = sh.ovf;
      sh.found = 0;
      sh.maxp = 0;
    }
    __syncthreads();
    mask_phase(sh, t, d);

    // crash closure: at most n_crash + 1 rounds while successors survive
    int go = __syncthreads_or(tid < F && sh.vcr[tid] != 0ull);
    for (int round = 0; go && round < d.n_crash + 1; ++round) {
      int total = build_succ(sh, t, d, false, F);
      int progress;
      int nk = prune_compact(sh, d, true, 2 * F, min(total, F), &progress);
      Row z = zero_row();
      for (int r = tid; r < F; r += NTHREADS) sh.cur[r] = r < nk ? sh.nxt[r] : z;
      if (tid == 0) {
        if (total > F || nk > F) sh.ovf = 1;
        sh.count = min(nk, F);
      }
      __syncthreads();
      mask_phase(sh, t, d);
      go = progress;
    }
    // leaving by the round cap while still adding rows: not proven
    // closed, which degrades like an overflow
    if (tid == 0 && go) sh.ovf = 1;

    // determinate successors into the next level
    int total = build_succ(sh, t, d, true, SCAP);
    int nk = prune_compact(sh, d, false, SCAP, min(total, SCAP), nullptr);
    if (tid < sh.count) atomicMax(&sh.maxp, sh.cur[tid].p);
    __syncthreads();
    if (tid == 0) {
      if (total > SCAP || nk > F) sh.ovf = 1;
      sh.configs += sh.count;
      sh.md = max(sh.md, sh.maxp);
      if (sh.found) sh.status = 2;
      // uncommit an overflowing level when a wider re-run is coming and
      // no goal was found
      sh.revert = d.bail && sh.ovf && !sh.ovf0 && !sh.found;
      if (sh.revert) {
        sh.count = sh.cnt0;
        sh.configs = sh.cfg0;
        sh.md = sh.md0;
      } else {
        sh.count = min(nk, F);
      }
      sh.run = sh.status == -1 && sh.count > 0 && sh.configs < d.budget &&
               !(d.bail && sh.ovf);
    }
    __syncthreads();
    Row z = zero_row();
    for (int r = tid; r < F; r += NTHREADS)
      sh.cur[r] = sh.revert ? sh.snap[r] : (r < nk ? sh.nxt[r] : z);
    __syncthreads();
  }

  for (int r = tid; r < F; r += NTHREADS) {
    const Row& R = sh.cur[r];
    int* w = fout + r * WORDS;
    w[0] = R.p;
    w[1] = (int)(unsigned)(R.win & 0xffffffffull);
    if (d.WW == 2) w[2] = (int)(unsigned)(R.win >> 32);
    int* cw = w + 1 + d.WW;
    cw[0] = (int)(unsigned)(R.cr & 0xffffffffull);
    if (d.CW == 2) cw[1] = (int)(unsigned)(R.cr >> 32);
    for (int s = 0; s < d.SW; ++s) cw[d.CW + s] = R.st[s];
  }
  if (tid == 0) {
    scal_out[0] = sh.count;
    scal_out[1] = sh.status;
    scal_out[2] = sh.configs;
    scal_out[3] = sh.md;
    scal_out[4] = sh.ovf;
  }
}

extern "C" {

// Launch one slice on `stream`.  Returns cudaGetLastError() after the
// launch (0 on success); does not synchronise.
int jtt_level_loop(const int* det_f, const int* det_v1, const int* det_v2,
                   const int* det_inv, const int* det_ret, const int* sfx,
                   const int* crash_f, const int* crash_v1,
                   const int* crash_v2, const int* crash_inv,
                   const int* frontier_in, const int* scal_in,
                   int* frontier_out, int* scal_out, int F, int W, int NC,
                   int SW, int n_det, int n_crash, int budget, int lvl_cap,
                   int bail, int kid, void* stream) {
  if (F < 1 || F > MAXF || W < 32 || W > 64 || W % 32 || NC < 32 ||
      NC > 64 || NC % 32 || SW < 1 || SW > 4)
    return (int)cudaErrorInvalidValue;
  Tables t = {det_f, det_v1, det_v2, det_inv, det_ret, sfx,
              crash_f, crash_v1, crash_v2, crash_inv};
  Dims d = {F, W, NC, SW, W / 32, NC / 32,
            n_det, n_crash, budget, lvl_cap, bail, kid};
  level_loop_kernel<<<1, NTHREADS, 0, (cudaStream_t)stream>>>(
      t, d, frontier_in, scal_in, frontier_out, scal_out);
  return (int)cudaGetLastError();
}

const char* jtt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
