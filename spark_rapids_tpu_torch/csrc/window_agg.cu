// K12b: window frame aggregates (sum, count, avg; running min/max).
//
// Replaces spark_rapids_tpu/ops/window.py:164 `running_or_bounded_agg`,
// which XLA runs as prefix sums over the whole padded batch, read at each
// frame's edges (sum/count/avg), and as log2(capacity) sparse-table levels
// for min/max.
//
// Design, for rows sorted by (partition keys, order keys), with each row's
// partition start (K12a) and its inclusive frame [lo, hi] (the elementwise
// `_frame_edges` of ops/window.py, clamped to the partition):
//   * a segmented inclusive scan that restarts at every partition start
//     writes each row's running state: the sum (int64 for integral input,
//     wrapping; double over the finite values for fractional input), the
//     count of contributing (non-null) rows, and for fractional sums the
//     counts of NaN, +inf and -inf apart, so a non-finite value earlier in
//     the partition cannot poison a later frame's difference.  Min/max keep
//     the running extreme with Spark's float order (NaN is the largest
//     value, -0.0 is 0.0).  Three passes: each tile reduces its rows to one
//     piece (partition-start flag, state since the last start), one block
//     scans the pieces of all tiles, and each tile rescans its rows with its
//     carry-in and writes the states.  A partition's sum is folded in one
//     order on every run: no atomics.
//   * one pass per row evaluates the frame: state[hi] minus state[lo - 1]
//     inside the partition (nothing subtracted when lo is the partition
//     start).  An empty frame (lo > hi) counts 0 rows and gives null.
//     Min/max read state[hi]; they serve frames whose lower edge is the
//     partition start (running and whole-partition frames).  A bounded
//     lower edge goes to K12c (csrc/window_range.cu).
//
// Ops: 0 sum over integers, 1 sum over floats, 2 avg over integers, 3 avg
// over floats, 4 count, 5/6 min/max over integers (and bools and dates),
// 7/8 min/max over floats.
//
// Bound on the H100: bytes.  Per row it reads the value and its validity,
// the partition start and the two frame edges, and writes the result and
// its validity; the running states are scratch written and read once.
#include "common.cuh"

namespace srt_wagg {

using namespace srt;

enum Op {
  kSumI = 0, kSumF = 1, kAvgI = 2, kAvgF = 3, kCount = 4, kMinI = 5,
  kMaxI = 6, kMinF = 7, kMaxF = 8
};
enum ValKind { kInt = 0, kFloat = 1 };

struct St {
  double f;     // float sum (finite values) or float extreme
  long long i;  // integer sum or extreme
  int cnt;      // contributing rows
  int nan, pinf, ninf;
};

struct Piece {
  int flag;  // a partition starts inside the piece
  St s;
};

struct Vals {
  const void* data;
  const uint8_t* valid;
  int kind;
  int item;
};

// Running state arrays (null where the op keeps no such field).
struct Run {
  double* f;
  long long* i;
  int32_t* cnt;
  int32_t* nan;
  int32_t* pinf;
  int32_t* ninf;
};

__device__ __forceinline__ St ident() { return St{0.0, 0, 0, 0, 0, 0}; }

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

// Spark order for doubles: NaN is larger than every other value.
__device__ __forceinline__ bool nan_less(double a, double b) {
  return (a < b) || (b != b && a == a);
}

template <int kOp>
__device__ __forceinline__ St lift(const Vals& v, int64_t i) {
  St s = ident();
  s.cnt = 1;
  if (kOp == kSumI || kOp == kAvgI || kOp == kMinI || kOp == kMaxI) {
    s.i = load_i64(v, i);
  } else if (kOp == kSumF || kOp == kAvgF) {
    const double x = load_f64(v, i);
    if (x != x) s.nan = 1;
    else if (x == __longlong_as_double(0x7ff0000000000000LL)) s.pinf = 1;
    else if (x == -__longlong_as_double(0x7ff0000000000000LL)) s.ninf = 1;
    else s.f = x;
  } else if (kOp == kMinF || kOp == kMaxF) {
    const double x = load_f64(v, i);
    s.f = x == 0.0 ? 0.0 : x;  // -0.0 -> 0.0
  }
  return s;
}

template <int kOp>
__device__ __forceinline__ St comb(const St& a, const St& b) {
  if (kOp == kMinI || kOp == kMaxI || kOp == kMinF || kOp == kMaxF) {
    if (a.cnt == 0) return b;
    if (b.cnt == 0) return a;
    St r = a;
    r.cnt = a.cnt + b.cnt;
    if (kOp == kMinI) r.i = b.i < a.i ? b.i : a.i;
    if (kOp == kMaxI) r.i = b.i > a.i ? b.i : a.i;
    if (kOp == kMinF) r.f = nan_less(b.f, a.f) ? b.f : a.f;
    if (kOp == kMaxF) r.f = nan_less(a.f, b.f) ? b.f : a.f;
    return r;
  }
  St r;
  r.f = a.f + b.f;
  r.i = (long long)((unsigned long long)a.i + (unsigned long long)b.i);
  r.cnt = a.cnt + b.cnt;
  r.nan = a.nan + b.nan;
  r.pinf = a.pinf + b.pinf;
  r.ninf = a.ninf + b.ninf;
  return r;
}

template <int kOp>
struct PieceOp {
  __device__ Piece operator()(const Piece& x, const Piece& y) const {
    Piece r;
    r.flag = x.flag | y.flag;
    r.s = y.flag ? y.s : comb<kOp>(x.s, y.s);
    return r;
  }
};

template <int kOp>
__device__ __forceinline__ void fold(Piece& p, const Vals& v,
                                     const int32_t* seg_start, int64_t i) {
  if (seg_start[i] == (int32_t)i) {
    p.flag = 1;
    p.s = ident();
  }
  if (v.valid[i]) p.s = comb<kOp>(p.s, lift<kOp>(v, i));
}

__device__ __forceinline__ void store_run(const Run& r, int64_t i,
                                          const St& s) {
  if (r.f) r.f[i] = s.f;
  if (r.i) r.i[i] = s.i;
  r.cnt[i] = s.cnt;
  if (r.nan) {
    r.nan[i] = s.nan;
    r.pinf[i] = s.pinf;
    r.ninf[i] = s.ninf;
  }
}

__device__ __forceinline__ St load_run(const Run& r, int64_t i) {
  St s = ident();
  if (r.f) s.f = r.f[i];
  if (r.i) s.i = r.i[i];
  s.cnt = r.cnt[i];
  if (r.nan) {
    s.nan = r.nan[i];
    s.pinf = r.pinf[i];
    s.ninf = r.ninf[i];
  }
  return s;
}

// kWrite = false: tiles[t] = the tile's piece.  kWrite = true: rescan the
// tile with carry[t] (the pieces of tiles < t, scanned) and write every
// row's running state.
template <int kOp, bool kWrite>
__global__ void __launch_bounds__(kThreads)
wagg_tile_kernel(Vals v, const int32_t* __restrict__ seg_start, int64_t n,
                 Piece* __restrict__ tiles, const Piece* __restrict__ carry,
                 Run run) {
  using BlockScan = cub::BlockScan<Piece, kThreads>;
  __shared__ typename BlockScan::TempStorage tmp;
  const int64_t r0 =
      (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kItems;
  Piece mine = {0, ident()};
#pragma unroll 4
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = r0 + k;
    if (i < n) fold<kOp>(mine, v, seg_start, i);
  }
  const Piece none = {0, ident()};
  Piece before, total;
  BlockScan(tmp).ExclusiveScan(mine, before, none, PieceOp<kOp>(), total);
  if (!kWrite) {
    if (threadIdx.x == 0) tiles[blockIdx.x] = total;
    return;
  }
  const Piece in = PieceOp<kOp>()(carry[blockIdx.x], before);
  St s = in.s;
#pragma unroll 4
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = r0 + k;
    if (i < n) {
      if (seg_start[i] == (int32_t)i) s = ident();
      if (v.valid[i]) s = comb<kOp>(s, lift<kOp>(v, i));
      store_run(run, i, s);
    }
  }
}

// One block: carry[t] = scan of tiles[0..t) (exclusive).  A 40-byte
// piece per item: a 1024-thread block would need more registers than an
// SM has, so this scan runs 256 threads.
constexpr int kPieceScanThreads = 256;

template <int kOp>
__global__ void __launch_bounds__(kPieceScanThreads)
wagg_scan_kernel(const Piece* __restrict__ tiles, Piece* __restrict__ carry,
                 int m) {
  using BlockScan = cub::BlockScan<Piece, kPieceScanThreads>;
  __shared__ typename BlockScan::TempStorage tmp;
  const Piece none = {0, ident()};
  Piece run = none;
  for (int base = 0; base < m; base += kPieceScanThreads * kScanItems) {
    Piece mine = none;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int i = base + threadIdx.x * kScanItems + k;
      if (i < m) mine = PieceOp<kOp>()(mine, tiles[i]);
    }
    Piece before, total;
    BlockScan(tmp).ExclusiveScan(mine, before, none, PieceOp<kOp>(), total);
    __syncthreads();
    Piece p = PieceOp<kOp>()(run, before);
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int i = base + threadIdx.x * kScanItems + k;
      if (i < m) {
        carry[i] = p;
        p = PieceOp<kOp>()(p, tiles[i]);
      }
    }
    run = PieceOp<kOp>()(run, total);
  }
}

struct Out {
  void* data;
  uint8_t* valid;
  int item;  // bytes of the output element (min/max keep the input's type)
};

__device__ __forceinline__ void store_i64(const Out& o, int64_t i,
                                          long long x) {
  switch (o.item) {
    case 1: static_cast<int8_t*>(o.data)[i] = (int8_t)x; break;
    case 2: static_cast<int16_t*>(o.data)[i] = (int16_t)x; break;
    case 4: static_cast<int32_t*>(o.data)[i] = (int32_t)x; break;
    default: static_cast<long long*>(o.data)[i] = x; break;
  }
}

__device__ __forceinline__ void store_f64(const Out& o, int64_t i, double x) {
  if (o.item == 4) static_cast<float*>(o.data)[i] = (float)x;
  else static_cast<double*>(o.data)[i] = x;
}

// Spark's sum of a frame whose non-finite values were counted apart.
__device__ __forceinline__ double special_or(const St& s, double finite) {
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  if (s.nan > 0 || (s.pinf > 0 && s.ninf > 0))
    return __longlong_as_double(0x7ff8000000000000LL);
  if (s.pinf > 0) return inf;
  if (s.ninf > 0) return -inf;
  return finite;
}

template <int kOp>
__global__ void wagg_eval_kernel(const int32_t* __restrict__ lo,
                                 const int32_t* __restrict__ hi,
                                 const int32_t* __restrict__ seg_start,
                                 int64_t n, Run run, Out out) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int l = lo[i], h = hi[i];
    St d = ident();
    if (l <= h) {
      d = load_run(run, h);
      if (kOp != kMinI && kOp != kMaxI && kOp != kMinF && kOp != kMaxF &&
          l > seg_start[i]) {
        const St a = load_run(run, l - 1);
        d.f -= a.f;
        d.i = (long long)((unsigned long long)d.i - (unsigned long long)a.i);
        d.cnt -= a.cnt;
        d.nan -= a.nan;
        d.pinf -= a.pinf;
        d.ninf -= a.ninf;
      }
    }
    const bool has = d.cnt > 0;
    if (kOp == kCount) {
      static_cast<long long*>(out.data)[i] = d.cnt;
      out.valid[i] = 1;
      continue;
    }
    out.valid[i] = has;
    switch (kOp) {
      case kSumI: store_i64(out, i, has ? d.i : 0); break;
      case kSumF: store_f64(out, i, has ? special_or(d, d.f) : 0.0); break;
      case kAvgI:
        store_f64(out, i, has ? (double)d.i / (double)d.cnt : 0.0);
        break;
      case kAvgF:
        store_f64(out, i, has ? special_or(d, d.f / (double)d.cnt) : 0.0);
        break;
      case kMinI: case kMaxI: store_i64(out, i, has ? d.i : 0); break;
      default: store_f64(out, i, has ? d.f : 0.0); break;
    }
  }
}

template <int kOp>
void launch(Vals v, const int32_t* seg_start, const int32_t* lo,
            const int32_t* hi, int64_t n, Piece* tiles, Piece* carry, Run run,
            Out out, cudaStream_t st) {
  const int nt = num_tiles(n);
  wagg_tile_kernel<kOp, false><<<nt, kThreads, 0, st>>>(v, seg_start, n,
                                                         tiles, carry, run);
  wagg_scan_kernel<kOp><<<1, kPieceScanThreads, 0, st>>>(tiles, carry, nt);
  wagg_tile_kernel<kOp, true><<<nt, kThreads, 0, st>>>(v, seg_start, n,
                                                        tiles, carry, run);
  wagg_eval_kernel<kOp><<<grid_for(n), kThreads, 0, st>>>(lo, hi, seg_start,
                                                          n, run, out);
}

}  // namespace srt_wagg

using namespace srt_wagg;

extern "C" {

// One frame aggregate over n >= 1 sorted rows.  tiles, carry: ntiles
// pieces of scratch each (sizeof(Piece) bytes, srt_window_agg_piece_bytes).
// run_*: n-element running-state scratch (run_cnt always; run_f for float
// ops, run_i for integer ops; run_nan/pinf/ninf for float sum and avg,
// else null).  out_data: int64 (count, integer sum), double (float sum,
// avg) or the input's type (min/max).
int srt_window_agg(int op, const void* data, const void* valid, int kind,
                   int item, const void* seg_start, const void* lo,
                   const void* hi, int64_t n, void* tiles, void* carry,
                   void* run_f, void* run_i, void* run_cnt, void* run_nan,
                   void* run_pinf, void* run_ninf, void* out_data,
                   void* out_valid, int out_item, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0 || n > 0x7fffffffLL || run_cnt == nullptr)
    return (int)cudaErrorInvalidValue;
  Vals v = {data, (const uint8_t*)valid, kind, item};
  Run r = {(double*)run_f, (long long*)run_i, (int32_t*)run_cnt,
           (int32_t*)run_nan, (int32_t*)run_pinf, (int32_t*)run_ninf};
  Out o = {out_data, (uint8_t*)out_valid, out_item};
  const int32_t* ss = (const int32_t*)seg_start;
  const int32_t* l = (const int32_t*)lo;
  const int32_t* h = (const int32_t*)hi;
  Piece* t = (Piece*)tiles;
  Piece* c = (Piece*)carry;
  switch (op) {
    case kSumI: launch<kSumI>(v, ss, l, h, n, t, c, r, o, st); break;
    case kSumF: launch<kSumF>(v, ss, l, h, n, t, c, r, o, st); break;
    case kAvgI: launch<kAvgI>(v, ss, l, h, n, t, c, r, o, st); break;
    case kAvgF: launch<kAvgF>(v, ss, l, h, n, t, c, r, o, st); break;
    case kCount: launch<kCount>(v, ss, l, h, n, t, c, r, o, st); break;
    case kMinI: launch<kMinI>(v, ss, l, h, n, t, c, r, o, st); break;
    case kMaxI: launch<kMaxI>(v, ss, l, h, n, t, c, r, o, st); break;
    case kMinF: launch<kMinF>(v, ss, l, h, n, t, c, r, o, st); break;
    case kMaxF: launch<kMaxF>(v, ss, l, h, n, t, c, r, o, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int srt_window_agg_piece_bytes() { return (int)sizeof(Piece); }

}  // extern "C"
