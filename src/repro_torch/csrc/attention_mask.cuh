// The attention kinds as one interval of keys per query position, shared
// by K4-K6 (flash_attention.cu) and K4's backward (flash_backward.cu).
#pragma once

// The attention kinds (kernels/flash_attention.py's MASK_CODES, the
// reference's attention_mask_ref, src/repro/kernels/ref.py:140-157).
enum MaskKind : int {
  MASK_GLOBAL = 0,   // causal
  MASK_LOCAL = 1,    // causal, the last `window` positions
  MASK_FULL = 2,     // every key (whisper)
  MASK_CHUNKED = 3,  // causal, the query's own chunk of `window` positions
  MASK_PREFIX = 4,   // causal, or a key before `prefix_len`
};

// The keys query position p >= 0 attends are one interval [lo(p), hi(p)]
// (with the keys' end, and K6's page mask, on top) under every kind:
// global [0, p], local [p - window + 1, p], chunked [p / window * window,
// p], prefix [0, max(p, prefix_len - 1)], full [0, KEY_MAX].  Both bounds
// are nondecreasing in p, so a tile is interior for a range of rows when
// it lies in [lo(last row), hi(first row)].  Read the other way, the
// queries that attend key k >= 0 are the interval [qlo(k), qhi(k)] (with
// the queries' end on top), which bounds the backward's dK/dV loop.
constexpr int KEY_MAX = 0x3fffffff;
struct Mask {
  int kind, window, prefix_len;
  __device__ __forceinline__ int lo(int p) const {
    return kind == MASK_LOCAL     ? p - window + 1
           : kind == MASK_CHUNKED ? p / window * window
                                  : 0;
  }
  __device__ __forceinline__ int hi(int p) const {
    return kind == MASK_FULL     ? KEY_MAX
           : kind == MASK_PREFIX ? max(p, prefix_len - 1)
                                 : p;
  }
  __device__ __forceinline__ int qlo(int k) const {
    return kind == MASK_FULL || (kind == MASK_PREFIX && k < prefix_len)
               ? 0
               : k;
  }
  __device__ __forceinline__ int qhi(int k) const {
    return kind == MASK_LOCAL     ? k + window - 1
           : kind == MASK_CHUNKED ? (k / window + 1) * window - 1
                                  : KEY_MAX;
  }
};

// A mask the kernels take: a known kind, a window >= 1 where the kind has
// one, a prefix length >= 0, and the kinds each kernel serves (`kinds`,
// a bit per MaskKind).
inline bool mask_ok(const Mask& m, int kinds) {
  if (m.kind < 0 || m.kind > MASK_PREFIX || !((kinds >> m.kind) & 1))
    return false;
  const bool windowed = m.kind == MASK_LOCAL || m.kind == MASK_CHUNKED;
  return (windowed ? m.window >= 1 : m.window == 0) && m.prefix_len >= 0 &&
         (m.kind == MASK_PREFIX || m.prefix_len == 0);
}
