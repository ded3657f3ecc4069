// K13c: concat / concat_ws of up to 8 byte-matrix string pieces.
//
// Replaces spark_rapids_tpu/expr/strings.py:252 `_concat2_device`, which
// `Concat._eval` (:235) and `ConcatWs._eval` (:484) fold pairwise: XLA
// runs each step as two take_along_axis gathers of the whole [n, W]
// matrices and a select, so k pieces move the growing result k times.
//
// Semantics.  A piece is a column (one row per output row) or a one-row
// literal read by every row; each has its own width Wp (a multiple of 4),
// int32 lengths and validity.  Concat mode: the result is the pieces'
// bytes end to end, null (zeros, length 0) where any piece is null.
// ConcatWs mode: null pieces are skipped, the separator goes before
// every non-null piece that follows another non-null one (empty pieces
// count), and the result is never null.  The output row is out_w bytes
// (the caller's round_string_width of the widths and separators): the
// result first, zeros after it -- equality, In, sort words and group keys
// compare whole padded rows.
//
// Design.  G lanes per output row: G = 1 while the row is at most 32
// bytes (a thread a row: the lane-group version was instruction-bound at
// W 16 in K13a), else one lane per 16-byte vector of the row, up to 32.
// Every lane walks the row's pieces once (their lengths and validity,
// broadcast loads) and keeps each piece's and each separator's output
// offset in registers; then for
// each of its output words it ORs, per segment, two source words
// funnel-shifted by the segment's byte offset and masked to the bytes the
// segment covers.  No byte is written twice and no shared memory or
// shuffle is used; a lane writes whole 16-byte vectors (4-byte words
// where the row width is not a multiple of 16).
//
// Bound on the H100: bytes.  The function reads each piece's rows (the
// literal rows once), lengths and validities, and writes the output rows,
// lengths and validity; the work per output word is a few integer
// operations per piece.
#include <cstdint>
#include <cuda_runtime.h>

namespace srt_cat {

constexpr int kBlock = 256;
constexpr int kMaxPieces = 8;

struct Piece {
  const uint32_t* data;  // [rows, w / 4] words
  const int32_t* len;
  const uint8_t* valid;
  int nw;       // words per row
  int per_row;  // 0: one row, read by every output row
};

struct Args {
  Piece p[kMaxPieces];
  int k;
  int64_t n;
  const uint32_t* sep;  // one row of sep_nw words (ConcatWs mode)
  int sep_nw;
  int sep_len;
  int ws;  // 1: ConcatWs mode
  int out_nw;
  uint32_t* out;
  int32_t* out_len;
  uint8_t* out_valid;
};

// Bytes [b0, b1) of a word set (0 <= b0 < b1 <= 4).
__device__ __forceinline__ uint32_t byte_mask(int b0, int b1) {
  const uint32_t hi = b1 >= 4 ? 0xffffffffu : ((1u << (8 * b1)) - 1u);
  return hi & ~((1u << (8 * b0)) - 1u);
}

// The part of output word w that a segment of `len` bytes starting at
// output byte `off` covers, read from the segment's source row.
__device__ __forceinline__ uint32_t seg_word(const uint32_t* row, int nw,
                                             int off, int len, int w) {
  const int b0 = max(off - 4 * w, 0);
  const int b1 = min(off + len - 4 * w, 4);
  if (b0 >= b1) return 0u;
  const int src = 4 * w - off;  // source byte of output byte 4w
  const int q = src >> 2;       // floor division (arithmetic shift)
  const int r = src & 3;
  const uint32_t x0 = (q >= 0 && q < nw) ? __ldg(row + q) : 0u;
  const uint32_t x1 = (q + 1 >= 0 && q + 1 < nw) ? __ldg(row + q + 1) : 0u;
  return __funnelshift_r(x0, x1, 8 * r) & byte_mask(b0, b1);
}

template <int G, int V>
__global__ void __launch_bounds__(kBlock) concat_kernel(Args a) {
  const int lane = threadIdx.x % G;
  const int64_t rows_per_block = kBlock / G;
  for (int64_t i = (int64_t)blockIdx.x * rows_per_block + threadIdx.x / G;
       i < a.n; i += (int64_t)gridDim.x * rows_per_block) {
    // the row's segments: piece p at off[p] (len[p] bytes, 0 if skipped),
    // its separator at soff[p] (slen[p] bytes, 0 if none)
    int off[kMaxPieces], len[kMaxPieces], soff[kMaxPieces],
        slen[kMaxPieces];
    const uint32_t* src[kMaxPieces];
    bool all_valid = true, have_any = false;
    int pos = 0;
#pragma unroll
    for (int p = 0; p < kMaxPieces; ++p) {
      off[p] = len[p] = soff[p] = slen[p] = 0;
      src[p] = nullptr;
      if (p < a.k) {
        const Piece& pc = a.p[p];
        const int64_t r = pc.per_row ? i : 0;
        const bool v = pc.valid[r] != 0;
        all_valid = all_valid && v;
        src[p] = pc.data + r * pc.nw;
        if (a.ws && v && have_any) {
          soff[p] = pos;
          slen[p] = a.sep_len;
          pos += a.sep_len;
        }
        if (v || !a.ws) {
          off[p] = pos;
          len[p] = v ? pc.len[r] : 0;
          pos += len[p];
        }
        have_any = have_any || v;
      }
    }
    const bool valid = a.ws || all_valid;
    auto word = [&](int w) {
      uint32_t x = 0u;
      if (valid) {
#pragma unroll
        for (int p = 0; p < kMaxPieces; ++p) {
          if (p < a.k) {
            x |= seg_word(src[p], a.p[p].nw, off[p], len[p], w);
            if (slen[p]) x |= seg_word(a.sep, a.sep_nw, soff[p], slen[p], w);
          }
        }
      }
      return x;
    };
    uint32_t* orow = a.out + i * a.out_nw;
    for (int c = lane; c < a.out_nw / V; c += G) {
      if (V == 4) {
        reinterpret_cast<uint4*>(orow)[c] =
            make_uint4(word(4 * c), word(4 * c + 1), word(4 * c + 2),
                       word(4 * c + 3));
      } else {
        orow[c] = word(c);
      }
    }
    if (lane == 0) {
      a.out_len[i] = valid ? pos : 0;
      a.out_valid[i] = valid ? 1 : 0;
    }
  }
}

template <int G, int V>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int64_t rows_per_block = kBlock / G;
  int64_t blocks = (a.n + rows_per_block - 1) / rows_per_block;
  const int64_t cap = 132 * 16;
  if (blocks > cap) blocks = cap;
  concat_kernel<G, V><<<(int)blocks, kBlock, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace srt_cat

using namespace srt_cat;

extern "C" {

// Host arrays of k entries describe the pieces: device pointers to their
// data ([rows, widths[p]] bytes, 4-byte aligned), int32 lengths and uint8
// validity, and per_row[p] (1: n rows, 0: one row).  sep is one device
// row of sep_w bytes holding sep_len separator bytes (ws 1 only).  out is
// uint8 [n, out_w] (out_w a multiple of 4 at least the widths' sum plus
// (k - 1) * sep_len), out_len int32 [n], out_valid uint8 [n].
int srt_concat(int k, const void* const* datas, const int* widths,
               const void* const* lens, const void* const* valids,
               const int* per_row, int64_t n, const void* sep, int sep_w,
               int sep_len, int ws, int out_w, void* out, void* out_len,
               void* out_valid, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (k < 1 || k > kMaxPieces || out_w % 4 != 0 || out_w <= 0 ||
      (ws && (sep == nullptr || sep_w % 4 != 0 || sep_len > sep_w)))
    return (int)cudaErrorInvalidValue;
  Args a = {};
  int64_t need = ws ? (int64_t)(k - 1) * sep_len : 0;
  for (int p = 0; p < k; ++p) {
    if (widths[p] % 4 != 0 || widths[p] <= 0)
      return (int)cudaErrorInvalidValue;
    a.p[p].data = (const uint32_t*)datas[p];
    a.p[p].len = (const int32_t*)lens[p];
    a.p[p].valid = (const uint8_t*)valids[p];
    a.p[p].nw = widths[p] / 4;
    a.p[p].per_row = per_row[p];
    need += widths[p];
  }
  if (need > out_w) return (int)cudaErrorInvalidValue;
  a.k = k;
  a.n = n;
  a.sep = (const uint32_t*)sep;
  a.sep_nw = sep_w / 4;
  a.sep_len = sep_len;
  a.ws = ws;
  a.out_nw = out_w / 4;
  a.out = (uint32_t*)out;
  a.out_len = (int32_t*)out_len;
  a.out_valid = (uint8_t*)out_valid;
  cudaStream_t s = (cudaStream_t)stream;
  if (a.out_nw % 4 != 0) {  // rows of 4, 8, 12, ... bytes: word stores
    if (out_w <= 32) return (int)launch<1, 1>(a, s);
    return (int)(a.out_nw < 32 ? launch<16, 1>(a, s) : launch<32, 1>(a, s));
  }
  // 16-byte vector stores: a thread a row up to 32 bytes, then one lane
  // per vector of the row, up to 32
  const int vecs = a.out_nw / 4;
  if (out_w <= 32) return (int)launch<1, 4>(a, s);
  if (vecs <= 4) return (int)launch<4, 4>(a, s);
  if (vecs <= 8) return (int)launch<8, 4>(a, s);
  if (vecs <= 16) return (int)launch<16, 4>(a, s);
  return (int)launch<32, 4>(a, s);
}

}  // extern "C"
