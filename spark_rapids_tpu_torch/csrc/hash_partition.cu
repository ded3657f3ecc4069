// K9: Spark murmur3_x86_32 (seed 42) over the key columns, then the pmod
// partition id.
//
// Replaces spark_rapids_tpu/expr/hashing.py:208 `murmur3_val` (with its
// per-type helpers `_hash_int` :66, `_hash_long` :73, `_float_bits` :81,
// `_double_bits` :90, `_hash_string_device` :181) as folded by
// spark_rapids_tpu/parallel/mesh_shuffle.py:50 `partition_ids_for_keys`.
// XLA runs those as one elementwise uint32 pass per key column, and for a
// string key one pass per 4-byte block of the padded byte matrix.
//
// Design: one launch per map batch, one thread per row (grid-stride).  The
// thread folds every key column into its running uint32 hash in key order
// -- a null key passes the hash through -- and writes pmod(int32(h), P),
// or the hash bits when P == 0 (the Murmur3Hash expression, and the first
// launches of a key list longer than kMaxKeys, which chain through
// seed_in).  Semantics, each bit-exact with Spark and the reference:
//   * byte/short/int/date/bool hash the sign-extended 32-bit value;
//   * long/timestamp hash the low then the high word;
//   * float -0.0 hashes as 0.0, NaN as 0x7FC00000; double as 0.0 and
//     0x7FF8000000000000;
//   * a string hashes its 4-byte little-endian blocks, then each tail byte
//     sign-extended (byte - 256 for bytes >= 128, Spark's hashUnsafeBytes);
//     fmix takes the byte length;
//   * pmod: C's % truncates, so a negative remainder gets P added.
//
// Bound on the H100: bytes.  Each key byte, validity byte and string length
// is read once and one int32 is written per row; the mixing is ~10 integer
// operations per 4 key bytes, far below the card's integer rate.  A string
// row's bytes are read by one thread (strided across the warp), which the
// 50 MB L2 absorbs at the shuffle's batch sizes.
#include "common.cuh"

namespace srt_hash {

constexpr int kMaxKeys = 16;
constexpr int kHashThreads = 256;

enum Kind { kI8 = 0, kI16, kI32, kI64, kF32, kF64, kBool, kStr };

struct Key {
  const void* data;
  const uint8_t* valid;
  const int32_t* lens;  // strings only
  int32_t kind;
  int32_t width;        // strings: bytes per row of the matrix
};

struct Keys {
  Key k[kMaxKeys];
  int32_t n;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix_k1(uint32_t k1) {
  k1 *= 0xCC9E2D51u;
  k1 = rotl(k1, 15);
  return k1 * 0x1B873593u;
}

__device__ __forceinline__ uint32_t mix_h1(uint32_t h1, uint32_t k1) {
  h1 ^= k1;
  h1 = rotl(h1, 13);
  return h1 * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fmix(uint32_t h1, uint32_t len) {
  h1 ^= len;
  h1 ^= h1 >> 16;
  h1 *= 0x85EBCA6Bu;
  h1 ^= h1 >> 13;
  h1 *= 0xC2B2AE35u;
  return h1 ^ (h1 >> 16);
}

__device__ __forceinline__ uint32_t hash_int(uint32_t v, uint32_t seed) {
  return fmix(mix_h1(seed, mix_k1(v)), 4u);
}

__device__ __forceinline__ uint32_t hash_long(uint64_t v, uint32_t seed) {
  uint32_t h = mix_h1(seed, mix_k1((uint32_t)v));
  h = mix_h1(h, mix_k1((uint32_t)(v >> 32)));
  return fmix(h, 8u);
}

__device__ uint32_t hash_bytes(const uint8_t* p, int len, uint32_t seed) {
  uint32_t h = seed;
  const int nb = len >> 2;
  for (int j = 0; j < nb; ++j) {
    const uint8_t* q = p + 4 * j;
    const uint32_t block = (uint32_t)q[0] | ((uint32_t)q[1] << 8) |
                           ((uint32_t)q[2] << 16) | ((uint32_t)q[3] << 24);
    h = mix_h1(h, mix_k1(block));
  }
  for (int j = nb * 4; j < len; ++j) {
    const int32_t s = (int8_t)p[j];  // signed tail byte
    h = mix_h1(h, mix_k1((uint32_t)s));
  }
  return fmix(h, (uint32_t)len);
}

__device__ __forceinline__ uint32_t hash_key(const Key& c, int64_t i,
                                             uint32_t h) {
  switch (c.kind) {
    case kI8:
      return hash_int((uint32_t)(int32_t)((const int8_t*)c.data)[i], h);
    case kI16:
      return hash_int((uint32_t)(int32_t)((const int16_t*)c.data)[i], h);
    case kI32:
      return hash_int((uint32_t)((const int32_t*)c.data)[i], h);
    case kI64:
      return hash_long((uint64_t)((const int64_t*)c.data)[i], h);
    case kF32: {
      const float f = ((const float*)c.data)[i];
      const uint32_t bits = f == 0.0f ? 0u
                            : isnan(f) ? 0x7FC00000u
                                       : __float_as_uint(f);
      return hash_int(bits, h);
    }
    case kF64: {
      const double f = ((const double*)c.data)[i];
      const uint64_t bits =
          f == 0.0 ? 0ull
          : isnan(f) ? 0x7FF8000000000000ull
                     : (uint64_t)__double_as_longlong(f);
      return hash_long(bits, h);
    }
    case kBool:
      return hash_int(((const uint8_t*)c.data)[i] != 0 ? 1u : 0u, h);
    default: {  // kStr: lengths never exceed the width (column invariant)
      const int len = min(c.lens[i], c.width);
      return hash_bytes((const uint8_t*)c.data + i * (int64_t)c.width, len,
                        h);
    }
  }
}

__global__ void hash_partition_kernel(Keys keys, int64_t n,
                                      const uint32_t* seed_in, uint32_t seed,
                                      int32_t num_parts, int32_t* out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint32_t h = seed_in != nullptr ? seed_in[i] : seed;
    for (int k = 0; k < keys.n; ++k) {
      const Key& c = keys.k[k];
      if (c.valid[i] != 0) h = hash_key(c, i, h);
    }
    if (num_parts > 0) {
      int32_t p = (int32_t)h % num_parts;
      if (p < 0) p += num_parts;
      out[i] = p;
    } else {
      out[i] = (int32_t)h;
    }
  }
}

}  // namespace srt_hash

using namespace srt_hash;

extern "C" {

// Host arrays of nkeys (<= kMaxKeys) entries describe the key columns:
// kinds (Kind), widths (string matrix widths), data / valid / lens device
// addresses.  seed_in (may be null, and may equal out) holds each row's
// running hash from an earlier launch; otherwise every row starts at seed.
// out[i] = pmod(int32(h), num_parts), or the hash bits when num_parts == 0.
int srt_hash_partition(const int* kinds, const int* widths,
                       const int64_t* data, const int64_t* valid,
                       const int64_t* lens, int nkeys, int64_t n,
                       const void* seed_in, unsigned int seed, int num_parts,
                       void* out, void* stream) {
  if (nkeys < 0 || nkeys > kMaxKeys) return (int)cudaErrorInvalidValue;
  Keys keys;
  keys.n = nkeys;
  for (int k = 0; k < nkeys; ++k) {
    keys.k[k].data = (const void*)data[k];
    keys.k[k].valid = (const uint8_t*)valid[k];
    keys.k[k].lens = (const int32_t*)lens[k];
    keys.k[k].kind = kinds[k];
    keys.k[k].width = widths[k];
  }
  if (n > 0) {
    const int64_t want = (n + kHashThreads - 1) / kHashThreads;
    const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
    hash_partition_kernel<<<blocks, kHashThreads, 0, (cudaStream_t)stream>>>(
        keys, n, (const uint32_t*)seed_in, (uint32_t)seed, num_parts,
        (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
