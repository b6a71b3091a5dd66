// Depthwise 7x7 convolution, stride 1, SAME zero padding, plus bias, for
// sm_90a:
//
//     out[n, y, x, c] = b[c] + sum_{ky, kx} x[n, y + ky - 3, x + kx - 3, c] * w[ky, kx, 0, c]
//
// Replaces the Pallas TPU kernel of mmgclip_tpu/ops/depthwise_conv.py
// (`_dw_call` / `_dw_kernel`), which holds one zero-padded image in VMEM and
// accumulates 49 shifted multiply-adds.
//
// Layout: x / out [n, H, W, C] (NHWC, contiguous), w [7, 7, 1, C] (HWIO),
// b [C]; all of one type T (float or __nv_bfloat16).  Any H, W >= 1, any C.
// Sums in fp32 in the order (ky, kx), one rounding to T.
//
// The kernel is the shared-memory halo tile of depthwise_tile.cuh (its
// design and what bounds it are described there), with the output in x's
// type; the fused ConvNeXt block (fused_block.cu) runs the same tile with
// an fp32 output as its front half.

#include "depthwise_tile.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
int mmg_depthwise_conv7x7(int dtype, const void* x, const void* w, const void* b, void* out,
                          int n, int h, int wd, int c, void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)mmg::dwtile::launch<float, float>(x, w, b, out, n, h, wd, c, s);
  if (dtype == 1)
    return (int)mmg::dwtile::launch<__nv_bfloat16, __nv_bfloat16>(x, w, b, out, n, h, wd, c, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
