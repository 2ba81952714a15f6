// The bilateral texture filter's whole call, nitr iterations of its four
// kernels, enqueued by one C call: host code only.
//
// An iteration is the gradient magnitude (csrc/gradient.cu), box blur +
// mRTV and the guide (csrc/bilateral_texture.cu), then the joint bilateral
// filter of window 2k - 1 (csrc/bilateral.cu), launched through those
// files' own C entry points, in that order, with the arguments the Python
// wrappers give them one launch at a time.  The caller allocates every
// buffer; this file allocates nothing and never synchronizes.

extern "C" {

int vip_gradient(const void* src, void* out, int height, int width, int channels,
                 int is_float, void* stream);
int vip_blur_rtv(const void* img, const void* magnitude, void* blurred, void* rtv, int height,
                 int width, int ksize, float epsilon, void* stream);
int vip_guide(const void* blurred, const void* rtv, void* guide, int height, int width,
              int ksize, float sigma_alpha, void* stream);
int vip_bilateral_u8(const void* src, const void* guide, void* out, int height, int width,
                     const void* taps, int n_taps, const void* lut, int radius, int border,
                     int rounding, void* stream);

// src, out, image: (height, width, 3) u8; magnitude, rtv: (height, width)
// f32; blurred: (height, width, 3) f32; guide: (height, width, 3) u8.  The
// iterations' images alternate between image and out, so that the last one
// is written to out and src is only read.  taps and lut: the joint filter's
// tables, as vip_bilateral_u8 takes them for radius ksize - 1.
// Stops at the first launch that fails and returns its cudaError_t (0 when
// every launch went in); *launched is the number of kernels enqueued, so
// launch *launched % 4 of an iteration is the one that failed.
int vip_btf_u8(const void* src, void* out, void* magnitude, void* blurred, void* rtv,
               void* guide, void* image, int height, int width, int ksize, int nitr,
               const void* taps, int n_taps, const void* lut, int border, int rounding,
               float epsilon, float sigma_alpha, void* stream, int* launched) {
  *launched = 0;
  const void* img = src;
  for (int i = 0; i < nitr; ++i) {
    void* dst = (nitr - 1 - i) % 2 == 0 ? out : image;
    int err = vip_gradient(img, magnitude, height, width, 3, 0, stream);
    if (err != 0) return err;
    ++*launched;
    err = vip_blur_rtv(img, magnitude, blurred, rtv, height, width, ksize, epsilon, stream);
    if (err != 0) return err;
    ++*launched;
    err = vip_guide(blurred, rtv, guide, height, width, ksize, sigma_alpha, stream);
    if (err != 0) return err;
    ++*launched;
    err = vip_bilateral_u8(img, guide, dst, height, width, taps, n_taps, lut, ksize - 1, border,
                           rounding, stream);
    if (err != 0) return err;
    ++*launched;
    img = dst;
  }
  return 0;
}

}  // extern "C"
