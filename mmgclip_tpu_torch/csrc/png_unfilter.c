/* Undo the five PNG row filters (None, Sub, Up, Average, Paeth) in place.
 *
 * Host C, built by `cc` into a shared library and called through ctypes by
 * ingest/png_reader.py: the port's counterpart of the unfilter step inside
 * libpng, which the JAX package's native/png_decode.cc calls.  Inflate stays
 * with the standard library's zlib.
 *
 * `data` holds `height` scanlines of `1 + stride` bytes each, the filter byte
 * first.  Each row is unfiltered in place against the already unfiltered row
 * above it (zeros above the first row), so after the call row y's bytes
 * 1..stride are its raw bytes and its filter byte is untouched.  An Adam7
 * pass is a separate call: the row above its first row is zeros, as for an
 * image.
 *
 * Returns 0, or 1 + the index of the first row whose filter byte is not one
 * of the five (the rows before it are unfiltered, the rest are not).
 *
 * Arithmetic follows the PNG standard and the port's plain version
 * (`_unfilter` / `_unfilter_loop`): sums modulo 256, Average as
 * (left + up) >> 1 in int, Paeth ties broken a, then b, then c.
 */

#include <stdlib.h>

static unsigned char paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return (unsigned char)a;
  return (unsigned char)(pb <= pc ? b : c);
}

int mmg_png_unfilter(int height, long long stride, int bpp, unsigned char* data) {
  const long long pitch = stride + 1;
  const long long lead = bpp < stride ? bpp : stride; /* bytes without a left neighbour */
  const unsigned char* prev = 0; /* the unfiltered row above; 0 = zeros */
  for (int y = 0; y < height; ++y) {
    unsigned char* cur = data + (long long)y * pitch + 1;
    long long i;
    switch (cur[-1]) {
      case 0:
        break;
      case 1:
        for (i = lead; i < stride; ++i) cur[i] = (unsigned char)(cur[i] + cur[i - bpp]);
        break;
      case 2:
        if (prev)
          for (i = 0; i < stride; ++i) cur[i] = (unsigned char)(cur[i] + prev[i]);
        break;
      case 3:
        if (prev) {
          for (i = 0; i < lead; ++i) cur[i] = (unsigned char)(cur[i] + (prev[i] >> 1));
          for (; i < stride; ++i)
            cur[i] = (unsigned char)(cur[i] + ((cur[i - bpp] + prev[i]) >> 1));
        } else {
          for (i = lead; i < stride; ++i) cur[i] = (unsigned char)(cur[i] + (cur[i - bpp] >> 1));
        }
        break;
      case 4:
        if (prev) {
          /* no left neighbour: a = c = 0, so the predictor is b */
          for (i = 0; i < lead; ++i) cur[i] = (unsigned char)(cur[i] + prev[i]);
          for (; i < stride; ++i)
            cur[i] = (unsigned char)(cur[i] + paeth(cur[i - bpp], prev[i], prev[i - bpp]));
        } else {
          /* no row above: b = c = 0, so the predictor is a (Sub) */
          for (i = lead; i < stride; ++i) cur[i] = (unsigned char)(cur[i] + cur[i - bpp]);
        }
        break;
      default:
        return y + 1;
    }
    prev = cur;
  }
  return 0;
}
