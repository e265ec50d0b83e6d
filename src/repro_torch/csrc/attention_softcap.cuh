// gemma2's score softcap, shared by K4 and K6's chunk body
// (flash_attention.cu) and K4's backward (flash_backward.cu), so the
// backward recomputes every capped score bit for bit as the forward
// rounded it.
#pragma once

// tanh(x / softcap), with `rcp` = __frcp_rn(softcap) rounded once per
// thread.  The division is IEEE-rounded without the division routine:
// with q0 = RN(x rcp) and the exact residual x - softcap q0 (an fma),
// RN(q0 + residual rcp) is the correctly rounded x / softcap for every x
// of normal magnitude (Markstein's theorem), in three FMA-pipe
// instructions.  tanh(y) = 1 - 2 / (exp(2 y) + 1) with the fast exp and
// division (absolute error about 1e-7, far inside the bf16 rounding of
// P).  The softcap is on every score, and tanhf and the division routine
// would triple the special-function work of the tile.
__device__ __forceinline__ float softcap_tanh(float x, float softcap,
                                              float rcp) {
  const float q0 = __fmul_rn(x, rcp);
  const float y = fmaf(fmaf(-softcap, q0, x), rcp, q0);
  return 1.0f - __fdividef(2.0f, __expf(2.0f * y) + 1.0f);
}

// softcap * tanh(x / softcap): the capped score.  Its derivative in x is
// 1 - t^2 with t = softcap_tanh(x, softcap, rcp), which the backward
// multiplies into dS.
__device__ __forceinline__ float softcap_score(float x, float softcap,
                                               float rcp) {
  return softcap * softcap_tanh(x, softcap, rcp);
}
