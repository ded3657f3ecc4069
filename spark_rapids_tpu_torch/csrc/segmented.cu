// K4: segmented aggregation over key-sorted rows.
//
// Replaces spark_rapids_tpu/ops/segmented.py:68 `sorted_group_by` (with
// `_cols_differ` :50 and `_compute_agg` :163), which XLA runs as boundary
// flags, a cumsum into segment ids, and one segment_sum/min/max per
// aggregate over a capacity-sized segment space.
//
// Design, for rows already sorted by the keys (K1 + K3):
//   * seg_flags_kernel, once per key column: flag[i] = 1 where row i's key
//     differs from row i-1's (null == null, NaN == NaN, -0.0 == 0.0,
//     strings by bytes and length), flag[0] = 1.
//   * the flag scan shared with K2 (common.cuh flag_scan) gives each tile
//     the number of segments started before it; its total is the group
//     count, which the wrapper reads once to size the outputs.
//   * seg_starts_kernel compacts the row index of every flag: the first
//     row of each group (the group keys are gathered from it by K3).
//   * per aggregate, seg_tile_kernel reduces every tile on its own: each
//     thread folds 16 consecutive rows, a cub::BlockScan with the
//     segmented operator (flag, state) hands each thread the open
//     segment's state so far, and every piece of a segment that ends in the
//     tile (at a flag or at the tile's end) is written to its own slot.
//     The slot of the piece ending at row r is tile_offset + tile +
//     (flags in the tile up to r), so the pieces of segment g sit in the
//     consecutive slots [g + 1 + tile(start g), g + 2 + tile(start g+1)).
//   * seg_combine_kernel gives each segment one warp, which folds its
//     pieces in a fixed order (a contiguous run per lane, then an ordered
//     shuffle tree) and writes the result.  No atomics: a sum comes out the
//     same on every run, and first/last keep their row order.
//
// Covered ops: sum (int64 and double accumulation), avg, count,
// count_star, min/max over integers, booleans, dates and floats (Spark
// NaN semantics: NaN is the largest value), and first/last with or without
// ignoreNulls (as a row index; the wrapper gathers the values with K3).
//
// Bound on the H100: bytes.  Each aggregate reads its input column and its
// validity once, plus one flag byte a row; the key columns are read once
// by the flag kernel.  The outputs hold one row per group.
//
// K4p, the percentile pick (srt_seg_percentile), replaces
// spark_rapids_tpu/ops/segmented.py:262-281: rows arrive sorted by (keys,
// value ascending, value nulls last) from K1 (:84-91), so segment g's valid
// values are values[start[g] .. start[g] + count[g]), NaN last.  One thread
// per (q, segment) computes pos = (count - 1) * q, lo = floor(pos), hi =
// ceil(pos) and v[lo] + (v[hi] - v[lo]) * (pos - lo); one launch serves
// every q over a column.  Every step is written with an explicitly
// rounded intrinsic, so nvcc cannot contract the multiply-add into an FMA
// and the result equals the plain PyTorch version (and the reference's
// formula) bit for bit: inf - inf gives NaN, as there.  Bound: bytes, per
// (q, segment) a 4 B start, an 8 B count, two 8 B gathers, 8 B + 1 B out.
//
// K4s, string min/max (srt_seg_string_minmax), replaces
// spark_rapids_tpu/ops/segmented.py:216-238, which sorts (segment,
// non-contributing flag, the string's key words) with lax.sort and takes
// each segment's first row.  Rows reach K4 already sorted by the keys,
// with the segment flags and starts of the boundary pass, so the second
// sort is not needed: K4s is the same tile + combine reduction as the
// other aggregates, its state the row index of the least (greatest) valid
// string so far.  Two rows compare as the reference's sort operands
// order them (ops/sort.py encode_key_operands): the padded bytes as
// big-endian 32-bit words, then the length (a NUL tail sorts by length);
// rows equal in both hold the same bytes, so which of them wins does not
// change the result.  Null rows never win; a segment without a valid row
// gets -1, and the wrapper gathers the winners with K3 (-1: a null row).
// One segment of 2^24 rows is folded by 4096 tiles and one warp over their
// pieces; 2^20 one-row segments by one warp each.  Bound: bytes, each row
// read once (its words up to the first difference), plus its length,
// validity and flag; the winners' rows once more by K3.
#include "common.cuh"

namespace srt_seg {

using namespace srt;

enum ValKind { kInt = 0, kFloat = 1, kBool = 2, kString = 3 };

enum AggOp {
  kSumI = 0, kSumF = 1, kAvg = 2, kCount = 3, kCountStar = 4, kMinI = 5,
  kMaxI = 6, kMinF = 7, kMaxF = 8, kFirst = 9, kLast = 10,
  kFirstNonNull = 11, kLastNonNull = 12, kMinS = 13, kMaxS = 14
};

constexpr unsigned kFull = 0xffffffffu;

struct Vals {
  const void* data;
  const uint8_t* valid;
  int kind;
  int item;
};

__device__ __forceinline__ long long load_i64(const Vals& v, int64_t i) {
  switch (v.item) {
    case 1: return static_cast<const int8_t*>(v.data)[i];
    case 2: return static_cast<const int16_t*>(v.data)[i];
    case 4: return static_cast<const int32_t*>(v.data)[i];
    default: return static_cast<const long long*>(v.data)[i];
  }
}

__device__ __forceinline__ double load_f64(const Vals& v, int64_t i) {
  if (v.kind == kFloat)
    return v.item == 4 ? (double)static_cast<const float*>(v.data)[i]
                       : static_cast<const double*>(v.data)[i];
  return (double)load_i64(v, i);
}

template <typename A>
struct St {
  A acc;
  long long cnt;
};

// Spark order for doubles: NaN is larger than every other value.
__device__ __forceinline__ bool nan_less(double a, double b) {
  return (a < b) || (b != b && a == a);
}

struct SumI {
  typedef long long A;
  static __device__ bool elig(bool valid) { return valid; }
  static __device__ A lift(const Vals& v, int64_t i) { return load_i64(v, i); }
  static __device__ St<A> comb(St<A> a, St<A> b) {
    return {(A)((unsigned long long)a.acc + (unsigned long long)b.acc),
            a.cnt + b.cnt};
  }
};
struct SumF {
  typedef double A;
  static __device__ bool elig(bool valid) { return valid; }
  static __device__ A lift(const Vals& v, int64_t i) { return load_f64(v, i); }
  static __device__ St<A> comb(St<A> a, St<A> b) {
    return {a.acc + b.acc, a.cnt + b.cnt};
  }
};
template <bool kAll>
struct CountOp {
  typedef long long A;
  static __device__ bool elig(bool valid) { return kAll || valid; }
  static __device__ A lift(const Vals&, int64_t) { return 0; }
  static __device__ St<A> comb(St<A> a, St<A> b) { return {0, a.cnt + b.cnt}; }
};
template <bool kMax>
struct MinMaxI {
  typedef long long A;
  static __device__ bool elig(bool valid) { return valid; }
  static __device__ A lift(const Vals& v, int64_t i) { return load_i64(v, i); }
  static __device__ St<A> comb(St<A> a, St<A> b) {
    if (a.cnt == 0) return b;
    if (b.cnt == 0) return a;
    const bool take_b = kMax ? (b.acc > a.acc) : (b.acc < a.acc);
    return {take_b ? b.acc : a.acc, a.cnt + b.cnt};
  }
};
template <bool kMax>
struct MinMaxF {
  typedef double A;
  static __device__ bool elig(bool valid) { return valid; }
  static __device__ A lift(const Vals& v, int64_t i) {
    const double x = load_f64(v, i);
    return x == 0.0 ? 0.0 : x;  // -0.0 -> 0.0
  }
  static __device__ St<A> comb(St<A> a, St<A> b) {
    if (a.cnt == 0) return b;
    if (b.cnt == 0) return a;
    const bool take_b = kMax ? nan_less(a.acc, b.acc) : nan_less(b.acc, a.acc);
    return {take_b ? b.acc : a.acc, a.cnt + b.cnt};
  }
};
template <bool kLastOp, bool kAll>
struct Pick {  // first/last row index among eligible rows
  typedef long long A;
  static __device__ bool elig(bool valid) { return kAll || valid; }
  static __device__ A lift(const Vals&, int64_t i) { return i; }
  static __device__ St<A> comb(St<A> a, St<A> b) {
    if (kLastOp) return b.cnt > 0 ? St<A>{b.acc, a.cnt + b.cnt} : a;
    return a.cnt > 0 ? St<A>{a.acc, a.cnt + b.cnt} : b;
  }
};

// K4s: the state holds a row index; comb reads both rows' bytes.
template <bool kMax>
struct MinMaxS {
  typedef long long A;
  const uint32_t* data;  // [n, nw] words, 4-byte aligned
  const int32_t* lens;
  int nw;
  static __device__ bool elig(bool valid) { return valid; }
  static __device__ A lift(const Vals&, int64_t i) { return i; }
  // <0, 0, >0 as row i sorts before, with or after row j
  __device__ int cmp(long long i, long long j) const {
    const uint32_t* x = data + i * nw;
    const uint32_t* y = data + j * nw;
    for (int k = 0; k < nw; ++k) {
      const uint32_t a = x[k], b = y[k];
      if (a != b)
        return __byte_perm(a, 0, 0x0123) < __byte_perm(b, 0, 0x0123) ? -1 : 1;
    }
    return lens[i] < lens[j] ? -1 : (lens[i] > lens[j] ? 1 : 0);
  }
  __device__ St<A> comb(St<A> a, St<A> b) const {
    if (a.cnt == 0) return b;
    if (b.cnt == 0) return a;
    const int c = cmp(a.acc, b.acc);
    const bool take_b = kMax ? (c < 0) : (c > 0);
    return {take_b ? b.acc : a.acc, a.cnt + b.cnt};
  }
};

template <class Op>
struct Piece {
  int f;
  St<typename Op::A> s;
};

template <class Op>
struct PieceScanOp {
  Op fold;
  __device__ Piece<Op> operator()(const Piece<Op>& x,
                                  const Piece<Op>& y) const {
    Piece<Op> r;
    r.f = x.f | y.f;
    r.s = y.f ? y.s : fold.comb(x.s, y.s);
    return r;
  }
};

template <class Op>
__global__ void seg_tile_kernel(Op fold, Vals v,
                                const uint8_t* __restrict__ flags,
                                int64_t n,
                                const int32_t* __restrict__ tile_offsets,
                                St<typename Op::A>* __restrict__ slots) {
  typedef St<typename Op::A> S;
  typedef cub::BlockScan<int, kThreads> IntScan;
  typedef cub::BlockScan<Piece<Op>, kThreads> PieceScan;
  __shared__ union {
    typename IntScan::TempStorage i;
    typename PieceScan::TempStorage p;
  } tmp;
  const S ident = {typename Op::A(0), 0};
  const int64_t base = (int64_t)blockIdx.x * kTile;
  const int64_t r0 = base + (int64_t)threadIdx.x * kItems;
  int nflags = 0;
  S tail = ident;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = r0 + k;
    if (i < n) {
      if (flags[i]) {
        ++nflags;
        tail = ident;
      }
      if (fold.elig(v.valid[i] != 0))
        tail = fold.comb(tail, S{fold.lift(v, i), 1});
    }
  }
  int kbefore;
  IntScan(tmp.i).ExclusiveSum(nflags, kbefore);
  __syncthreads();
  Piece<Op> in;
  in.f = nflags > 0;
  in.s = tail;
  Piece<Op> init;
  init.f = 0;
  init.s = ident;
  Piece<Op> carry;
  PieceScan(tmp.p).ExclusiveScan(in, carry, init, PieceScanOp<Op>{fold});
  const int64_t slot0 = (int64_t)tile_offsets[blockIdx.x] + blockIdx.x;
  const int64_t last = (base + kTile < n ? base + kTile : n) - 1;
  S run = carry.s;
  int k = kbefore;
#pragma unroll
  for (int kk = 0; kk < kItems; ++kk) {
    const int64_t i = r0 + kk;
    if (i < n) {
      if (flags[i]) {
        slots[slot0 + k] = run;
        ++k;
        run = ident;
      }
      if (fold.elig(v.valid[i] != 0))
        run = fold.comb(run, S{fold.lift(v, i), 1});
      if (i == last) slots[slot0 + k] = run;
    }
  }
}

struct Out {
  void* data;
  uint8_t* valid;
  int kind;  // of the output column (min/max keep the input's type)
  int item;
};

__device__ __forceinline__ void store_i64(const Out& o, int64_t g, long long x) {
  switch (o.item) {
    case 1: static_cast<int8_t*>(o.data)[g] = (int8_t)x; break;
    case 2: static_cast<int16_t*>(o.data)[g] = (int16_t)x; break;
    case 4: static_cast<int32_t*>(o.data)[g] = (int32_t)x; break;
    default: static_cast<long long*>(o.data)[g] = x; break;
  }
}

__device__ __forceinline__ void store_f64(const Out& o, int64_t g, double x) {
  if (o.item == 4) static_cast<float*>(o.data)[g] = (float)x;
  else static_cast<double*>(o.data)[g] = x;
}

template <typename A>
__device__ __forceinline__ St<A> shfl_down(St<A> s, int off) {
  St<A> r;
  r.acc = __shfl_down_sync(kFull, s.acc, off);
  r.cnt = __shfl_down_sync(kFull, s.cnt, off);
  return r;
}

template <class Op>
__global__ void seg_combine_kernel(Op fold, const St<typename Op::A>*
                                                __restrict__ slots,
                                   const int32_t* __restrict__ starts, int G,
                                   int ntiles, int op, Out out) {
  typedef St<typename Op::A> S;
  const int64_t g = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= G) return;  // warp-uniform
  const int64_t lo = g + 1 + starts[g] / kTile;
  const int64_t hi = (g + 1 < G) ? g + 2 + starts[g + 1] / kTile
                                 : (int64_t)G + ntiles;
  const int64_t chunk = (hi - lo + 31) / 32;
  const int64_t a = lo + lane * chunk;
  const int64_t b = (a + chunk < hi) ? a + chunk : hi;
  S st = {typename Op::A(0), 0};
  for (int64_t j = a; j < b; ++j) st = fold.comb(st, slots[j]);
  for (int off = 1; off < 32; off <<= 1) {
    const S o = shfl_down(st, off);
    if ((lane & (2 * off - 1)) == 0) st = fold.comb(st, o);
  }
  if (lane != 0) return;
  const bool has = st.cnt > 0;
  switch (op) {
    case kCount:
    case kCountStar:
      static_cast<long long*>(out.data)[g] = st.cnt;
      out.valid[g] = 1;
      break;
    case kAvg:
      static_cast<double*>(out.data)[g] = has ? (double)st.acc / (double)st.cnt : 0.0;
      out.valid[g] = has;
      break;
    case kFirst: case kLast: case kFirstNonNull: case kLastNonNull:
    case kMinS: case kMaxS:
      static_cast<int32_t*>(out.data)[g] = has ? (int32_t)st.acc : -1;
      break;
    default:  // sums and min/max: the result type's zero when empty
      if (out.kind == kFloat) store_f64(out, g, has ? (double)st.acc : 0.0);
      else store_i64(out, g, has ? (long long)st.acc : 0);
      out.valid[g] = has;
      break;
  }
}

template <class Op>
void launch_agg(Vals v, const uint8_t* flags, int64_t n,
                const int32_t* tile_offsets, const int32_t* starts, int G,
                void* slots, int op, Out out, cudaStream_t st,
                Op fold = Op()) {
  const int nt = num_tiles(n);
  typedef St<typename Op::A> S;
  seg_tile_kernel<Op><<<nt, kThreads, 0, st>>>(fold, v, flags, n,
                                               tile_offsets, (S*)slots);
  const int64_t threads = (int64_t)G * 32;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  seg_combine_kernel<Op><<<blocks, kThreads, 0, st>>>(
      fold, (const S*)slots, starts, G, nt, op, out);
}

__global__ void seg_flags_kernel(const void* __restrict__ data,
                                 const uint8_t* __restrict__ valid,
                                 const int32_t* __restrict__ lens, int kind,
                                 int item, uint8_t* __restrict__ flags,
                                 int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    if (i == 0) {
      flags[0] = 1;
      continue;
    }
    const bool v = valid[i] != 0, vp = valid[i - 1] != 0;
    bool diff = false;
    if (kind == kString) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(
          static_cast<const uint8_t*>(data) + i * item);
      const uint32_t* wp = reinterpret_cast<const uint32_t*>(
          static_cast<const uint8_t*>(data) + (i - 1) * item);
      diff = lens[i] != lens[i - 1];
      for (int j = 0; j < item / 4 && !diff; ++j) diff = w[j] != wp[j];
    } else if (kind == kFloat) {
      double x, xp;
      if (item == 4) {
        x = static_cast<const float*>(data)[i];
        xp = static_cast<const float*>(data)[i - 1];
      } else {
        x = static_cast<const double*>(data)[i];
        xp = static_cast<const double*>(data)[i - 1];
      }
      diff = (x != xp) && !(x != x && xp != xp);  // -0.0 == 0.0 already
    } else {
      switch (item) {
        case 1: diff = static_cast<const uint8_t*>(data)[i] !=
                       static_cast<const uint8_t*>(data)[i - 1]; break;
        case 2: diff = static_cast<const uint16_t*>(data)[i] !=
                       static_cast<const uint16_t*>(data)[i - 1]; break;
        case 4: diff = static_cast<const uint32_t*>(data)[i] !=
                       static_cast<const uint32_t*>(data)[i - 1]; break;
        default: diff = static_cast<const unsigned long long*>(data)[i] !=
                        static_cast<const unsigned long long*>(data)[i - 1]; break;
      }
    }
    if ((v != vp) || (v && vp && diff)) flags[i] = 1;
  }
}

__global__ void seg_starts_kernel(const uint8_t* __restrict__ flags,
                                  int64_t n,
                                  const int32_t* __restrict__ tile_offsets,
                                  int32_t* __restrict__ starts) {
  using BlockScan = cub::BlockScan<int, kThreads>;
  __shared__ typename BlockScan::TempStorage tmp;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  int carry = tile_offsets[blockIdx.x];
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + (int64_t)k * kThreads + threadIdx.x;
    const int f = (i < n && flags[i] != 0) ? 1 : 0;
    int pos, agg;
    BlockScan(tmp).ExclusiveSum(f, pos, agg);
    __syncthreads();
    if (f) starts[carry + pos] = (int32_t)i;
    carry += agg;
  }
}

__global__ void seg_percentile_kernel(const double* __restrict__ values,
                                      int64_t n,
                                      const int32_t* __restrict__ starts,
                                      const long long* __restrict__ counts,
                                      int G, const double* __restrict__ qs,
                                      int nq, double* __restrict__ out,
                                      uint8_t* __restrict__ out_valid) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)G * nq) return;
  const int64_t g = t % G;
  const long long cnt = counts[g];
  if (cnt <= 0) {
    out[t] = 0.0;
    out_valid[t] = 0;
    return;
  }
  const double pos = __dmul_rn((double)(cnt - 1), qs[t / G]);
  const double flo = floor(pos);
  const long long lo = (long long)flo;
  const long long hi = (long long)ceil(pos);
  const double frac = __dsub_rn(pos, flo);
  const int64_t base = starts[g];
  const int64_t ilo = base + lo < n ? base + lo : n - 1;
  const int64_t ihi = base + hi < n ? base + hi : n - 1;
  const double vlo = values[ilo];
  const double vhi = values[ihi];
  out[t] = __dadd_rn(vlo, __dmul_rn(__dsub_rn(vhi, vlo), frac));
  out_valid[t] = 1;
}

}  // namespace srt_seg

using namespace srt_seg;

extern "C" {

// Mark key changes of one key column into flags (zeroed by the caller).
int srt_seg_flags(const void* data, const void* valid, const void* lens,
                  int kind, int item, void* flags, int64_t n, void* stream) {
  if (n > 0)
    seg_flags_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        data, (const uint8_t*)valid, (const int32_t*)lens, kind, item,
        (uint8_t*)flags, n);
  return (int)cudaGetLastError();
}

// tile_offsets[ntiles] becomes the number of groups.
int srt_seg_prepare(const void* flags, int64_t n, void* tile_counts,
                    void* tile_offsets, void* stream) {
  srt::flag_scan((const uint8_t*)flags, n, (int32_t*)tile_counts,
                 (int32_t*)tile_offsets, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

int srt_seg_starts(const void* flags, int64_t n, const void* tile_offsets,
                   void* starts, void* stream) {
  const int nt = srt::num_tiles(n);
  if (nt > 0)
    seg_starts_kernel<<<nt, srt::kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)flags, n, (const int32_t*)tile_offsets,
        (int32_t*)starts);
  return (int)cudaGetLastError();
}

// One aggregate over G >= 1 groups of n >= 1 rows.  slots: (G + ntiles)
// 16-byte states.  Output: count/count_star int64, sums int64 or double,
// avg double, min/max in (out_kind, out_item), first/last an int32 row
// index per group (-1: no eligible row).
int srt_seg_agg(int op, const void* data, const void* valid, int kind,
                int item, const void* flags, int64_t n,
                const void* tile_offsets, const void* starts, int G,
                void* slots, void* out_data, void* out_valid, int out_kind,
                int out_item, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Vals v = {data, (const uint8_t*)valid, kind, item};
  Out o = {out_data, (uint8_t*)out_valid, out_kind, out_item};
  const uint8_t* f = (const uint8_t*)flags;
  const int32_t* to = (const int32_t*)tile_offsets;
  const int32_t* s = (const int32_t*)starts;
  if (n <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  switch (op) {
    case kSumI: launch_agg<SumI>(v, f, n, to, s, G, slots, op, o, st); break;
    case kSumF:
    case kAvg: launch_agg<SumF>(v, f, n, to, s, G, slots, op, o, st); break;
    case kCount: launch_agg<CountOp<false>>(v, f, n, to, s, G, slots, op, o, st); break;
    case kCountStar: launch_agg<CountOp<true>>(v, f, n, to, s, G, slots, op, o, st); break;
    case kMinI: launch_agg<MinMaxI<false>>(v, f, n, to, s, G, slots, op, o, st); break;
    case kMaxI: launch_agg<MinMaxI<true>>(v, f, n, to, s, G, slots, op, o, st); break;
    case kMinF: launch_agg<MinMaxF<false>>(v, f, n, to, s, G, slots, op, o, st); break;
    case kMaxF: launch_agg<MinMaxF<true>>(v, f, n, to, s, G, slots, op, o, st); break;
    case kFirst: launch_agg<Pick<false, true>>(v, f, n, to, s, G, slots, op, o, st); break;
    case kLast: launch_agg<Pick<true, true>>(v, f, n, to, s, G, slots, op, o, st); break;
    case kFirstNonNull: launch_agg<Pick<false, false>>(v, f, n, to, s, G, slots, op, o, st); break;
    case kLastNonNull: launch_agg<Pick<true, false>>(v, f, n, to, s, G, slots, op, o, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K4s: out_idx int32 [G], per segment the row of the least (is_max: the
// greatest) valid string, -1 where the segment has none.  data uint8
// [n, w] (w a multiple of 4, 4-byte aligned), lens int32 [n]; flags,
// tile_offsets, starts and slots as for srt_seg_agg.
int srt_seg_string_minmax(int is_max, const void* data, const void* lens,
                          const void* valid, int w, const void* flags,
                          int64_t n, const void* tile_offsets,
                          const void* starts, int G, void* slots,
                          void* out_idx, void* stream) {
  if (n <= 0 || G <= 0 || w <= 0 || w % 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Vals v = {data, (const uint8_t*)valid, kString, w};
  Out o = {out_idx, nullptr, kInt, 4};
  const uint8_t* f = (const uint8_t*)flags;
  const int32_t* to = (const int32_t*)tile_offsets;
  const int32_t* s = (const int32_t*)starts;
  const uint32_t* words = (const uint32_t*)data;
  const int32_t* l = (const int32_t*)lens;
  if (is_max)
    launch_agg<MinMaxS<true>>(v, f, n, to, s, G, slots, kMaxS, o, st,
                              MinMaxS<true>{words, l, w / 4});
  else
    launch_agg<MinMaxS<false>>(v, f, n, to, s, G, slots, kMinS, o, st,
                               MinMaxS<false>{words, l, w / 4});
  return (int)cudaGetLastError();
}

// K4p: out and out_valid are [nq, G] (q-major); values float64 [n] sorted
// within each segment, counts int64 [G] valid values per segment.
int srt_seg_percentile(const void* values, int64_t n, const void* starts,
                       const void* counts, int G, const void* qs, int nq,
                       void* out, void* out_valid, void* stream) {
  const int64_t threads = (int64_t)G * nq;
  if (threads <= 0) return (int)cudaGetLastError();
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  seg_percentile_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)values, n, (const int32_t*)starts,
      (const long long*)counts, G, (const double*)qs, nq, (double*)out,
      (uint8_t*)out_valid);
  return (int)cudaGetLastError();
}

}  // extern "C"
