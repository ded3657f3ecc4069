// K14: the Generate exec's kernels -- explode(split(string, d)) and
// explode(array), with or without pos, with or without outer.
//
// Replaces spark_rapids_tpu/exec/generate.py:138 `_jit_counts` (K14a: the
// pieces of each row, a sum over an [n, W] compare), :149 `_jit_generate`
// with :210 `_first_ge` (K14b: every output slot searches its source row in
// the offsets, gathers the row's [W] cumulative delimiter count, finds the
// piece edges with two first-at-least reductions and gathers the piece
// bytes) and :90 `_jit_generate_array` (K14c: the same search, then one
// element gathered per slot).
//
// Design: source-row-major, so nothing searches.  A team of L lanes (a
// power of two, L <= 32; L * C <= W) reads one row in chunks of C bytes
// (16-byte vectors when W and the base allow, else 4-byte words), only up
// to the row's length.  A chunk's delimiter bytes become a bit mask (an
// exact SWAR zero-byte test of byte ^ d), the team ranks them with a
// prefix sum of popcounts (__shfl_up_sync within the team), and the lane
// that holds the delimiter ending piece r knows where the piece starts
// from the delimiter before it: in its own mask, or the last one of an
// earlier lane (a team max-scan), or of an earlier window (a carry).
//   * split_counts_kernel (K14a) writes emit[row] = delimiters + 1 for a
//     valid row, 0 for a null one (1 under outer), and folds the batch's
//     total (int64) and widest piece into stats with one atomic each per
//     warp, so that the host reads both in one copy and sizes the output
//     (the piece column's width W' is the widest piece, bucketed).
//   * split_emit_kernel (K14b) writes output row offsets[row] + r for
//     piece r: src = row, pos = r, the piece's length, validity 1 and its
//     bytes, shifted into place with funnel shifts of the row's 4-byte
//     words and zero past the length up to W'.  Under outer a null row
//     writes one null row.  offsets are K7's exclusive scan of emit
//     (join_expand.cu srt_join_offsets).
//   * array_emit_kernel (K14c): one thread per element slot (row, k) of
//     the [n, W] matrix; k < the row's count copies data[row, k] to output
//     offsets[row] + k with src and pos; under outer, slot (row, 0) of a
//     null or empty array writes one null row.
// The delimiter is one ASCII byte (< 0x80): it never equals a byte of a
// multi-byte UTF-8 sequence, so byte positions are piece edges.
//
// Bound on the H100: bytes.  K14a reads the bytes inside the lengths and
// the lengths and validity, and writes emit; K14b reads them again and
// offsets, and writes total * (W' + 13) bytes; K14c reads the elements
// inside the lengths and writes total * (elem + 9) bytes.  A piece's bytes
// are re-read by the lane that writes it, from L1.
#include "common.cuh"

namespace srt_generate {

using namespace srt;

// Bit b set when byte b of w equals d (exact: no borrow crosses a byte).
__device__ __forceinline__ uint32_t delim_bits4(uint32_t w, uint32_t d4) {
  const uint32_t x = w ^ d4;
  const uint32_t t = ~(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x | 0x7f7f7f7fu);
  return ((t >> 7) & 1u) | ((t >> 14) & 2u) | ((t >> 21) & 4u) |
         ((t >> 28) & 8u);
}

// Delimiter mask of the C bytes at row byte `off`, cut at `len`.
template <int C>
__device__ __forceinline__ uint32_t chunk_mask(const uint8_t* row, int off,
                                               int len, uint32_t d4) {
  if (off >= len) return 0u;
  uint32_t m;
  if (C == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + off));
    m = delim_bits4(v.x, d4) | (delim_bits4(v.y, d4) << 4) |
        (delim_bits4(v.z, d4) << 8) | (delim_bits4(v.w, d4) << 12);
  } else {
    m = delim_bits4(__ldg(reinterpret_cast<const uint32_t*>(row + off)), d4);
  }
  const int keep = len - off;
  if (keep < C) m &= (1u << keep) - 1u;
  return m;
}

struct Team {
  int lane;      // lane in the warp
  int sub;       // lane in the team
  int team;      // team in the warp
  uint32_t mask; // the team's lanes
  int width;     // L
};

__device__ __forceinline__ Team make_team(int L) {
  Team t;
  t.lane = threadIdx.x & 31;
  t.width = L;
  t.sub = t.lane & (L - 1);
  t.team = t.lane / L;
  t.mask = L == 32 ? 0xffffffffu : (((1u << L) - 1u) << (t.team * L));
  return t;
}

__device__ __forceinline__ int team_incl_sum(const Team& t, int v) {
  for (int d = 1; d < t.width; d <<= 1) {
    const int u = __shfl_up_sync(t.mask, v, d, t.width);
    if (t.sub >= d) v += u;
  }
  return v;
}

__device__ __forceinline__ int team_incl_max(const Team& t, int v) {
  for (int d = 1; d < t.width; d <<= 1) {
    const int u = __shfl_up_sync(t.mask, v, d, t.width);
    if (t.sub >= d) v = max(v, u);
  }
  return v;
}

__device__ __forceinline__ int team_last(const Team& t, int v) {
  return __shfl_sync(t.mask, v, t.width - 1, t.width);
}

// Rows handled by one warp at a time, and the first row and stride of this
// thread's team.
__device__ __forceinline__ void team_rows(const Team& t, int64_t& row,
                                          int64_t& stride) {
  const int per_warp = 32 / t.width;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  row = warp * per_warp + t.team;
  stride = warps * per_warp;
}

template <int C>
__global__ void __launch_bounds__(kThreads) split_counts_kernel(
    const uint8_t* __restrict__ data, int W,
    const int32_t* __restrict__ lengths, const uint8_t* __restrict__ valid,
    int64_t n, uint32_t d4, int outer, int L, int32_t* __restrict__ emit,
    unsigned long long* __restrict__ stats) {
  const Team t = make_team(L);
  int64_t row, stride;
  team_rows(t, row, stride);
  long long total = 0;
  int widest = 0;
  for (; row < n; row += stride) {
    if (!valid[row]) {
      if (t.sub == 0) {
        emit[row] = outer ? 1 : 0;
        total += outer ? 1 : 0;
      }
      continue;
    }
    const int len = lengths[row];
    const uint8_t* rp = data + row * (int64_t)W;
    int count = 0, carry = -1, gap = 0;
    for (int w0 = 0; w0 < len; w0 += L * C) {
      const int off = w0 + t.sub * C;
      uint32_t m = chunk_mask<C>(rp, off, len, d4);
      const int c = __popc(m);
      const int last = m ? off + 31 - __clz(m) : -1;
      const int lmax = team_incl_max(t, last);
      const int before = __shfl_up_sync(t.mask, lmax, 1, t.width);
      int prev = t.sub == 0 ? carry : max(carry, before);
      while (m) {
        const int p = off + __ffs(m) - 1;
        gap = max(gap, p - prev - 1);
        prev = p;
        m &= m - 1u;
      }
      count += team_last(t, team_incl_sum(t, c));
      carry = max(carry, team_last(t, lmax));
    }
    gap = max(gap, len - carry - 1);
    for (int d = 1; d < t.width; d <<= 1)
      gap = max(gap, __shfl_xor_sync(t.mask, gap, d, t.width));
    if (t.sub == 0) {
      emit[row] = count + 1;
      total += count + 1;
      widest = max(widest, gap);
    }
  }
  for (int d = 16; d > 0; d >>= 1) {
    total += __shfl_xor_sync(0xffffffffu, total, d);
    widest = max(widest, __shfl_xor_sync(0xffffffffu, widest, d));
  }
  if (t.lane == 0) {
    if (total) atomicAdd(&stats[0], (unsigned long long)total);
    if (widest) atomicMax(&stats[1], (unsigned long long)widest);
  }
}

// Piece bytes [s, s + plen) of a row of nw 4-byte words into nwp words of
// an output row, zero past plen.
__device__ __forceinline__ void write_piece_bytes(
    const uint32_t* __restrict__ rw, int nw, int s, int plen,
    uint32_t* __restrict__ ow, int nwp) {
  for (int k0 = 0; k0 < nwp; k0 += 4) {
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + j;
      const int rem = plen - 4 * k;
      uint32_t x = 0;
      if (k < nwp && rem > 0) {
        const int q = s + 4 * k;
        const int a = q >> 2, sh = (q & 3) * 8;
        const uint32_t lo = __ldg(rw + a);
        const uint32_t hi = (sh && a + 1 < nw) ? __ldg(rw + a + 1) : 0u;
        x = sh ? __funnelshift_r(lo, hi, sh) : lo;
        if (rem < 4) x &= (1u << (8 * rem)) - 1u;
      }
      v[j] = x;
    }
    if ((nwp & 3) == 0) {
      *reinterpret_cast<uint4*>(ow + k0) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + j < nwp) ow[k0 + j] = v[j];
    }
  }
}

struct EmitOut {
  uint8_t* data;   // [total, Wp]
  int Wp;
  int32_t* len;
  uint8_t* valid;
  int32_t* src;
  int32_t* pos;
};

__device__ __forceinline__ void emit_piece(const EmitOut& o, int64_t slot,
                                           const uint32_t* rw, int nw,
                                           int64_t row, int r, int s, int e) {
  const int plen = e - s;
  o.len[slot] = plen;
  o.valid[slot] = 1;
  o.src[slot] = (int32_t)row;
  o.pos[slot] = r;
  write_piece_bytes(rw, nw, s, plen,
                    reinterpret_cast<uint32_t*>(o.data + slot * o.Wp),
                    o.Wp / 4);
}

__device__ __forceinline__ void emit_null(const EmitOut& o, int64_t slot,
                                          int64_t row) {
  o.len[slot] = 0;
  o.valid[slot] = 0;
  o.src[slot] = (int32_t)row;
  o.pos[slot] = 0;
  uint32_t* ow = reinterpret_cast<uint32_t*>(o.data + slot * o.Wp);
  for (int k = 0; k < o.Wp / 4; ++k) ow[k] = 0u;
}

template <int C>
__global__ void __launch_bounds__(kThreads) split_emit_kernel(
    const uint8_t* __restrict__ data, int W,
    const int32_t* __restrict__ lengths, const uint8_t* __restrict__ valid,
    int64_t n, uint32_t d4, int outer, int L,
    const int32_t* __restrict__ offsets, EmitOut o) {
  const Team t = make_team(L);
  int64_t row, stride;
  team_rows(t, row, stride);
  const int nw = W / 4;
  for (; row < n; row += stride) {
    const int64_t base = offsets[row];
    if (!valid[row]) {
      if (outer && t.sub == 0) emit_null(o, base, row);
      continue;
    }
    const int len = lengths[row];
    const uint8_t* rp = data + row * (int64_t)W;
    const uint32_t* rw = reinterpret_cast<const uint32_t*>(rp);
    int rank = 0, carry = -1;
    for (int w0 = 0; w0 < len; w0 += L * C) {
      const int off = w0 + t.sub * C;
      uint32_t m = chunk_mask<C>(rp, off, len, d4);
      const int c = __popc(m);
      const int incl = team_incl_sum(t, c);
      const int last = m ? off + 31 - __clz(m) : -1;
      const int lmax = team_incl_max(t, last);
      const int before = __shfl_up_sync(t.mask, lmax, 1, t.width);
      int prev = t.sub == 0 ? carry : max(carry, before);
      int r = rank + incl - c;
      while (m) {
        const int p = off + __ffs(m) - 1;
        emit_piece(o, base + r, rw, nw, row, r, prev + 1, p);
        prev = p;
        ++r;
        m &= m - 1u;
      }
      rank += team_last(t, incl);
      carry = max(carry, team_last(t, lmax));
    }
    if (t.sub == 0) emit_piece(o, base + rank, rw, nw, row, rank, carry + 1,
                               len);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) array_emit_kernel(
    const T* __restrict__ data, int W, const int32_t* __restrict__ lengths,
    const uint8_t* __restrict__ valid, int64_t n, int outer,
    const int32_t* __restrict__ offsets, T* __restrict__ out,
    uint8_t* __restrict__ out_valid, int32_t* __restrict__ src,
    int32_t* __restrict__ pos) {
  const int64_t slots = n * (int64_t)W;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < slots;
       i += (int64_t)gridDim.x * kThreads) {
    const int64_t row = i / W;
    const int k = (int)(i - row * W);
    const int cnt = valid[row] ? lengths[row] : 0;
    if (k < cnt) {
      const int64_t o = (int64_t)offsets[row] + k;
      out[o] = data[i];
      out_valid[o] = 1;
      src[o] = (int32_t)row;
      pos[o] = k;
    } else if (outer && k == 0 && cnt == 0) {
      const int64_t o = offsets[row];
      out[o] = T(0);
      out_valid[o] = 0;
      src[o] = (int32_t)row;
      pos[o] = 0;
    }
  }
}

// Team shape of a split kernel: chunk bytes C and lanes L.
inline void split_shape(const void* data, int W, int& C, int& L) {
  C = ((uintptr_t)data % 16 == 0 && W % 16 == 0) ? 16 : 4;
  int l = W / C;
  L = 1;
  while (L * 2 <= l && L < 32) L *= 2;
}

inline int split_grid(int64_t n, int L) {
  const int64_t rows_per_block = (int64_t)(kThreads / 32) * (32 / L);
  int64_t blocks = (n + rows_per_block - 1) / rows_per_block;
  const int64_t cap = 132 * 16;
  if (blocks > cap) blocks = cap;
  return (int)(blocks > 0 ? blocks : 1);
}

}  // namespace srt_generate

using namespace srt_generate;

extern "C" {

// K14a.  data: uint8 [n, W] (W a multiple of 4, 4-byte aligned); lengths
// int32 [n]; validity bool [n]; emit int32 [n]; stats: two int64, set here
// to (the sum of emit, the widest piece of a valid row).
int srt_split_counts(const void* data, int W, const void* lengths,
                     const void* validity, int64_t n, int delim, int outer,
                     void* emit, void* stats, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (W % 4 != 0 || (uintptr_t)data % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaMemsetAsync(stats, 0, 2 * sizeof(unsigned long long), st);
  if (n == 0) return (int)cudaGetLastError();
  int C, L;
  split_shape(data, W, C, L);
  const uint32_t d4 = (uint32_t)(delim & 0xff) * 0x01010101u;
  const int g = split_grid(n, L);
  if (C == 16)
    split_counts_kernel<16><<<g, kThreads, 0, st>>>(
        (const uint8_t*)data, W, (const int32_t*)lengths,
        (const uint8_t*)validity, n, d4, outer, L, (int32_t*)emit,
        (unsigned long long*)stats);
  else
    split_counts_kernel<4><<<g, kThreads, 0, st>>>(
        (const uint8_t*)data, W, (const int32_t*)lengths,
        (const uint8_t*)validity, n, d4, outer, L, (int32_t*)emit,
        (unsigned long long*)stats);
  return (int)cudaGetLastError();
}

// K14b.  offsets: int32 [n + 1], the exclusive scan of K14a's emit.  out:
// uint8 [total, Wp] (Wp a multiple of 4 and at least the widest piece),
// out_len/src/pos int32 [total], out_valid bool [total].
int srt_split_emit(const void* data, int W, const void* lengths,
                   const void* validity, int64_t n, int delim, int outer,
                   const void* offsets, void* out, int Wp, void* out_len,
                   void* out_valid, void* src, void* pos, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (W % 4 != 0 || Wp % 4 != 0 || Wp <= 0 || (uintptr_t)data % 4 != 0 ||
      (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  int C, L;
  split_shape(data, W, C, L);
  const uint32_t d4 = (uint32_t)(delim & 0xff) * 0x01010101u;
  EmitOut o{(uint8_t*)out, Wp, (int32_t*)out_len, (uint8_t*)out_valid,
            (int32_t*)src, (int32_t*)pos};
  const int g = split_grid(n, L);
  if (C == 16)
    split_emit_kernel<16><<<g, kThreads, 0, st>>>(
        (const uint8_t*)data, W, (const int32_t*)lengths,
        (const uint8_t*)validity, n, d4, outer, L, (const int32_t*)offsets, o);
  else
    split_emit_kernel<4><<<g, kThreads, 0, st>>>(
        (const uint8_t*)data, W, (const int32_t*)lengths,
        (const uint8_t*)validity, n, d4, outer, L, (const int32_t*)offsets, o);
  return (int)cudaGetLastError();
}

// K14c.  data: [n, W] elements of elem_bytes (1, 2, 4 or 8); offsets int32
// [n + 1] from the counts (the lengths of valid rows; under outer at least
// 1 a row); out: [total] elements, out_valid bool, src and pos int32.
int srt_array_emit(const void* data, int elem_bytes, int W,
                   const void* lengths, const void* validity, int64_t n,
                   int outer, const void* offsets, void* out, void* out_valid,
                   void* src, void* pos, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n == 0 || W <= 0) return (int)cudaGetLastError();
  const int g = grid_for(n * (int64_t)W);
  const int32_t* ln = (const int32_t*)lengths;
  const uint8_t* vd = (const uint8_t*)validity;
  const int32_t* off = (const int32_t*)offsets;
  uint8_t* ov = (uint8_t*)out_valid;
  int32_t* sp = (int32_t*)src;
  int32_t* pp = (int32_t*)pos;
  switch (elem_bytes) {
    case 1: array_emit_kernel<uint8_t><<<g, kThreads, 0, st>>>(
        (const uint8_t*)data, W, ln, vd, n, outer, off, (uint8_t*)out, ov,
        sp, pp); break;
    case 2: array_emit_kernel<uint16_t><<<g, kThreads, 0, st>>>(
        (const uint16_t*)data, W, ln, vd, n, outer, off, (uint16_t*)out, ov,
        sp, pp); break;
    case 4: array_emit_kernel<uint32_t><<<g, kThreads, 0, st>>>(
        (const uint32_t*)data, W, ln, vd, n, outer, off, (uint32_t*)out, ov,
        sp, pp); break;
    case 8: array_emit_kernel<unsigned long long><<<g, kThreads, 0, st>>>(
        (const unsigned long long*)data, W, ln, vd, n, outer, off,
        (unsigned long long*)out, ov, sp, pp); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
