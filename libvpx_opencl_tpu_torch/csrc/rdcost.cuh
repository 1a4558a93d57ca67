// The RD cost of ops/rd_device.py:rdc, bit for bit, for the kernels that
// compare candidates by it (K5's B_PRED sub-mode pick, K6's trellis).
//
//   rdc = float(double(floor((128 + rate*rdmult)/256)) + double(rddiv)*dist)
//
// The floor term is float32 with each rounding explicit (product, sum,
// quotient), and the sum is taken in double with __dmul_rn/__dadd_rn and
// rounded to float once. The quotient by 256 is a product by 2^-8: for a
// finite float32 x >= 128 (no subnormal on either side) both are exact
// and equal, and the product is one instruction where the IEEE division is
// a dozen. The intrinsics keep nvcc from contracting a*b+c
// into an FMA, which would round once where the plain version rounds twice.
// tests/test_torch_encode_rowlag.py and tests/test_torch_trellis_k6.py hold
// this recipe, written out in numpy, against the plain function.
#pragma once

// floor((128 + r*rm)/256) in float32; r is an integer rate below 2^24
// (exact as a float), rm the float32 rdmult (times the plane's factor).
__device__ __forceinline__ float rdfloor(float r, float rm) {
  return floorf(__fmul_rn(__fadd_rn(128.0f, __fmul_rn(r, rm)), 0.00390625f));
}

// rdc of a candidate whose float32 floor term is `fl` and whose distortion
// is `dist` (an integer below 2^53, so exact as a double).
__device__ __forceinline__ float rdcost(float fl, double rddiv, double dist) {
  return __double2float_rn(__dadd_rn((double)fl, __dmul_rn(rddiv, dist)));
}
