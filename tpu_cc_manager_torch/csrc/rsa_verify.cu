// Kernel K6 of the evidence check: batched RS256 signature verification.
//
// Replaces no TPU kernel. The JAX package verifies each RS256 token of an
// evidence document (the instance-identity token and the Confidential Space
// attestation token) on the host, one at a time, in
// tpu_cc_manager/identity.py::_rsa_pkcs1_sha256_verify: s^e mod n with
// Python's pow, then an exact compare with the EMSA-PKCS1-v1_5 encoding of
// the SHA-256 digest. A rollout preflight over thousands of Confidential VMs
// verifies two such signatures a node, and the 2048-bit pow is nearly all
// of its time. Here one launch verifies every signature a group plan will
// check (rs256.py collects them): for each signature b,
//
//   ok[b] = (sig[b] ^ e mod n == EM(digest[b]))  under key key_index[b],
//   EM(d) = 00 01 FF..FF 00 || DigestInfo(SHA-256) || d   (256 bytes),
//
// the same bytes identity.py builds, compared exactly. Keys are 2048-bit
// (256-byte) odd moduli with an odd public exponent below 2^32; a signature
// must be 256 bytes and below n. The host sends anything else to pow (the
// wrapper's key table refuses such keys). A key index outside [0, keys)
// verifies nothing: ok is 0.
//
// Layout: numbers are little-endian 32-bit limbs, limb 0 least significant:
// sig [B, 64], digest [B, 8] (the digest's 32 bytes as the low 8 limbs of
// EM), key table n [K, 64], r2 = R^2 mod n [K, 64] with R = 2^2048,
// n0inv = -n^-1 mod 2^32 [K], e [K]. The host computes r2 and n0inv once a
// key and batch.
//
// What bounds it on an H100: 32-bit integer multiply throughput. A
// verification under e = 65537 is 19 Montgomery products (into the domain,
// 16 squarings, one multiply, out of it), each 2 x 64 x 64 multiply-adds of
// 32 x 32 -> 64 bits: about 156 k a signature, 1.5 G for a preflight's
// ~9 500 signatures. The bytes moved (about 290 per signature and 520 a key)
// are nothing beside that. Measured times: PERF.md.
//
// Design: right and simple first. A group of 8 lanes verifies one
// signature, four groups a warp; lane g owns limbs 8g..8g+7 of every number.
// Montgomery products are CIOS (coarsely integrated operand scanning): for
// each limb a_i of the first operand (broadcast from its owner by a
// shuffle), t += a_i * b, then m = t_0 * n0inv (broadcast from lane 0) and
// t = (t + m * n) / 2^32. Each lane keeps the carry out of its top limb in
// a 64-bit word instead of passing it on at once; the division by 2^32
// shifts every lane's limbs down by one, its top limb taking the next
// lane's limb 0 plus that carry, which keeps the carry below 4. Lane 0's
// limb 0 is exact throughout, as m needs. After the 64 steps the carries
// ripple up the lanes (7 rounds of shuffles), the group compares t with n
// by two ballots and subtracts n once if t >= n, its borrows rippling the
// same way. The exponent's bits run left to right; a warp runs to the
// longest exponent among its groups and a group keeps a product only for
// its own bits, so every shuffle is taken by all 32 lanes. Nothing is
// allocated; the launch's error code is returned.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLimbs = 64;               // 2048 bits in 32-bit limbs
constexpr int kLanes = 8;                // lanes a signature
constexpr int kPer = kLimbs / kLanes;    // limbs a lane
constexpr int kDigestLimbs = 8;          // the SHA-256 digest, EM's low end
constexpr int kThreads = 128;            // 16 signatures a block
constexpr unsigned kFull = 0xffffffffu;

// DER DigestInfo prefix for SHA-256 (RFC 8017 section 9.2, note 1)
__constant__ uint8_t kDigestInfo[19] = {
    0x30, 0x31, 0x30, 0x0d, 0x06, 0x09, 0x60, 0x86, 0x48, 0x01,
    0x65, 0x03, 0x04, 0x02, 0x01, 0x05, 0x00, 0x04, 0x20};

// Byte p of EM (p = 0 the most significant) above the digest (p < 224):
// 00 01, 202 bytes of FF, 00, then the 19-byte DigestInfo.
__device__ __forceinline__ uint32_t em_byte(int p) {
  if (p == 0) return 0x00u;
  if (p == 1) return 0x01u;
  if (p <= 203) return 0xffu;
  if (p == 204) return 0x00u;
  return kDigestInfo[p - 205];
}

// Limb li (li >= 8) of EM: bytes 252 - 4 li .. 255 - 4 li, big-endian.
__device__ __forceinline__ uint32_t em_limb(int li) {
  uint32_t v = 0;
#pragma unroll
  for (int q = 3; q >= 0; --q) v = (v << 8) | em_byte(255 - 4 * li - q);
  return v;
}

// out = a * b / R mod n, for a, b < n; lane g holds limbs 8g..8g+7 of each.
// out may be a or b.
__device__ __forceinline__ void mont_mul(uint32_t (&out)[kPer],
                                         const uint32_t (&a)[kPer],
                                         const uint32_t (&b)[kPer],
                                         const uint32_t (&n)[kPer],
                                         uint32_t n0inv, int g,
                                         int lane) {
  uint32_t t[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) t[k] = 0;
  // carry out of this lane's top limb: it belongs at the next lane's limb 0
  uint64_t hi = 0;
#pragma unroll 1
  for (int w = 0; w < kLanes; ++w) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const uint32_t ai = __shfl_sync(kFull, a[j], w, kLanes);
      uint64_t c = 0;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const uint64_t p = (uint64_t)ai * b[k] + t[k] + c;
        t[k] = (uint32_t)p;
        c = p >> 32;
      }
      hi += c;
      const uint32_t m = __shfl_sync(kFull, t[0] * n0inv, 0, kLanes);
      c = 0;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const uint64_t p = (uint64_t)m * n[k] + t[k] + c;
        t[k] = (uint32_t)p;
        c = p >> 32;
      }
      hi += c;
      // divide by 2^32: lane 0's limb 0 is 0 now and drops out; the top
      // limb takes the next lane's limb 0 and this lane's carry
      uint32_t up = __shfl_down_sync(kFull, t[0], 1, kLanes);
      if (g == kLanes - 1) up = 0;
#pragma unroll
      for (int k = 0; k < kPer - 1; ++k) t[k] = t[k + 1];
      const uint64_t s = (uint64_t)up + hi;
      t[kPer - 1] = (uint32_t)s;
      hi = s >> 32;
    }
  }
  // ripple the carries up the lanes; the top lane's is bit 2048 and above
  uint32_t top = 0;
  if (g == kLanes - 1) {
    top = (uint32_t)hi;
    hi = 0;
  }
#pragma unroll 1
  for (int r = 0; r < kLanes - 1; ++r) {
    uint64_t c = __shfl_up_sync(kFull, hi, 1, kLanes);
    if (g == 0) c = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const uint64_t s = (uint64_t)t[k] + c;
      t[k] = (uint32_t)s;
      c = s >> 32;
    }
    if (g == kLanes - 1) {
      top += (uint32_t)c;
      hi = 0;
    } else {
      hi = c;
    }
  }
  // t < 2n: subtract n once if t >= n. The highest lane whose limbs differ
  // from n's decides, unless a bit above 2^2048 is set.
  int cmp = 0;
#pragma unroll
  for (int k = kPer - 1; k >= 0; --k)
    if (cmp == 0 && t[k] != n[k]) cmp = t[k] > n[k] ? 1 : -1;
  const int base = lane & ~(kLanes - 1);
  const unsigned gt = (__ballot_sync(kFull, cmp > 0) >> base) & 0xffu;
  const unsigned lt = (__ballot_sync(kFull, cmp < 0) >> base) & 0xffu;
  const uint32_t top_bits = __shfl_sync(kFull, top, kLanes - 1, kLanes);
  const unsigned diff = gt | lt;
  const bool ge = top_bits != 0 || diff == 0 ||
                  ((gt >> (31 - __clz(diff))) & 1u);
  uint32_t borrow = 0;
  if (ge) {
    uint64_t bw = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const uint64_t d = (uint64_t)t[k] - n[k] - bw;
      t[k] = (uint32_t)d;
      bw = d >> 63;
    }
    borrow = (uint32_t)bw;
  }
#pragma unroll 1
  for (int r = 0; r < kLanes - 1; ++r) {
    uint32_t in = __shfl_up_sync(kFull, borrow, 1, kLanes);
    if (g == 0) in = 0;
    uint64_t bw = in;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const uint64_t d = (uint64_t)t[k] - bw;
      t[k] = (uint32_t)d;
      bw = d >> 63;
    }
    // the top lane's borrow cancels the bit above 2^2048
    borrow = g == kLanes - 1 ? 0u : (uint32_t)bw;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) out[k] = t[k];
}

__device__ __forceinline__ void copy(uint32_t (&dst)[kPer],
                                     const uint32_t (&src)[kPer]) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) dst[k] = src[k];
}

__global__ void __launch_bounds__(kThreads)
    rsa_verify_kernel(const uint32_t* __restrict__ sig,
                      const int32_t* __restrict__ key_index,
                      const uint32_t* __restrict__ digest,
                      const uint32_t* __restrict__ n_tab,
                      const uint32_t* __restrict__ r2_tab,
                      const uint32_t* __restrict__ n0inv_tab,
                      const uint32_t* __restrict__ e_tab, int batch,
                      int keys, uint8_t* __restrict__ ok) {
  const int lane = threadIdx.x & 31;
  const int g = lane & (kLanes - 1);
  const int64_t item =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / kLanes;
  // a group past the batch computes the last signature again and writes
  // nothing: every lane of the warp takes every shuffle
  const bool live = item < batch;
  const int64_t b = live ? item : (int64_t)batch - 1;
  int key = __ldg(key_index + b);
  const bool known = key >= 0 && key < keys;
  if (!known) key = 0;
  const int64_t limb0 = (int64_t)g * kPer;
  uint32_t n[kPer], s[kPer], r2[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    n[k] = __ldg(n_tab + (int64_t)key * kLimbs + limb0 + k);
    r2[k] = __ldg(r2_tab + (int64_t)key * kLimbs + limb0 + k);
    s[k] = __ldg(sig + b * kLimbs + limb0 + k);
  }
  const uint32_t n0inv = __ldg(n0inv_tab + key);
  const uint32_t e = __ldg(e_tab + key);

  uint32_t base[kPer], x[kPer], y[kPer];
  mont_mul(base, s, r2, n, n0inv, g, lane);  // s R mod n
  copy(x, base);
  const int bits = 32 - __clz(e);
  const int warp_bits = __reduce_max_sync(kFull, (unsigned)bits);
#pragma unroll 1
  for (int i = warp_bits - 2; i >= 0; --i) {
    const bool mine = i <= bits - 2;
    mont_mul(y, x, x, n, n0inv, g, lane);
    if (mine) copy(x, y);
    const bool mul = mine && ((e >> i) & 1u);
    if (__any_sync(kFull, mul)) {
      mont_mul(y, x, base, n, n0inv, g, lane);
      if (mul) copy(x, y);
    }
  }
  uint32_t one[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) one[k] = 0;
  if (g == 0) one[0] = 1;
  mont_mul(y, x, one, n, n0inv, g, lane);  // s^e mod n

  bool same = true;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int li = (int)limb0 + k;
    const uint32_t want = li < kDigestLimbs
                              ? __ldg(digest + b * kDigestLimbs + li)
                              : em_limb(li);
    same = same && y[k] == want;
  }
  const unsigned all =
      (__ballot_sync(kFull, same) >> (lane & ~(kLanes - 1))) & 0xffu;
  if (live && g == 0) ok[b] = (known && e != 0 && all == 0xffu) ? 1 : 0;
}

}  // namespace

// Launches K6 over `batch` signatures and `keys` keys on `stream` (see the
// layout above). Returns 0 or the CUDA error code of the launch.
extern "C" int tcc_rsa_verify(const void* sig, const void* key_index,
                              const void* digest, const void* n,
                              const void* r2, const void* n0inv,
                              const void* e, int batch, int keys, void* ok,
                              void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  const int64_t threads = (int64_t)batch * kLanes;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  rsa_verify_kernel<<<(unsigned int)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(sig),
      static_cast<const int32_t*>(key_index),
      static_cast<const uint32_t*>(digest),
      static_cast<const uint32_t*>(n), static_cast<const uint32_t*>(r2),
      static_cast<const uint32_t*>(n0inv), static_cast<const uint32_t*>(e),
      batch, keys, static_cast<uint8_t*>(ok));
  return (int)cudaGetLastError();
}
