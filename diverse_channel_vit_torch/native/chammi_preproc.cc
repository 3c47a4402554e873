// Native CHAMMI preprocessing: fused tape-unfold + crop + bilinear resize +
// normalize, the hot host-side path of the morphem70k loader.
//
// The tape format stores a (h, w*c) image whose channel k occupies columns
// [k*w, (k+1)*w) (the F-order reshape of datasets/morphem70k.py:163-186 in
// the reference). Doing unfold+interpolation+normalize in one pass avoids
// three numpy materializations per image and keeps loader threads cheap so
// the card stays fed. Bilinear semantics match torch interpolate
// (align_corners=False, edge-clamped), i.e. the numpy implementation in
// data/transforms.py (within 2e-5: float rounding differs).
//
// Built lazily with the host C++ compiler (see native/__init__.py), which
// raises when the build fails: the numpy pipeline in data/morphem70k.py is
// this function's plain version, not a fallback.

#include <cstdint>
#include <algorithm>

extern "C" {

// tape: (h, w*c) uint8 or uint16 (elem_size selects).
// crop: region [crop_y, crop_y+crop_h) x [crop_x, crop_x+crop_w) of the
//       unfolded (c, h, w) image, resized to (out_hw, out_hw).
// out:  float32 (c, out_hw, out_hw), value = (pixel/scale - mean[ch]) / std[ch].
void fold_crop_resize_normalize(
    const void* tape_raw, int elem_size, int h, int w, int c,
    int crop_y, int crop_x, int crop_h, int crop_w,
    float* out, int out_hw,
    const float* mean, const float* stddev, float scale) {
  const uint8_t* tape8 = static_cast<const uint8_t*>(tape_raw);
  const uint16_t* tape16 = static_cast<const uint16_t*>(tape_raw);
  const int stride = w * c;
  const float sy = static_cast<float>(crop_h) / out_hw;
  const float sx = static_cast<float>(crop_w) / out_hw;

  for (int ch = 0; ch < c; ++ch) {
    const float m = mean[ch];
    const float inv_s = 1.0f / stddev[ch];
    const int col0 = ch * w;
    float* dst = out + static_cast<long>(ch) * out_hw * out_hw;
    for (int oy = 0; oy < out_hw; ++oy) {
      // torch align_corners=False source coordinate, edge-clamped
      float fy = (oy + 0.5f) * sy - 0.5f;
      fy = std::min(std::max(fy, 0.0f), static_cast<float>(crop_h - 1));
      const int y0 = static_cast<int>(fy);
      const int y1 = std::min(y0 + 1, crop_h - 1);
      const float wy = fy - y0;
      const int ry0 = crop_y + y0, ry1 = crop_y + y1;
      for (int ox = 0; ox < out_hw; ++ox) {
        float fx = (ox + 0.5f) * sx - 0.5f;
        fx = std::min(std::max(fx, 0.0f), static_cast<float>(crop_w - 1));
        const int x0 = static_cast<int>(fx);
        const int x1 = std::min(x0 + 1, crop_w - 1);
        const float wx = fx - x0;
        const int rx0 = crop_x + x0, rx1 = crop_x + x1;

        float a, b, cc, d;
        if (elem_size == 1) {
          a = tape8[ry0 * stride + col0 + rx0];
          b = tape8[ry0 * stride + col0 + rx1];
          cc = tape8[ry1 * stride + col0 + rx0];
          d = tape8[ry1 * stride + col0 + rx1];
        } else {
          a = tape16[ry0 * stride + col0 + rx0];
          b = tape16[ry0 * stride + col0 + rx1];
          cc = tape16[ry1 * stride + col0 + rx0];
          d = tape16[ry1 * stride + col0 + rx1];
        }
        const float top = a * (1.0f - wx) + b * wx;
        const float bot = cc * (1.0f - wx) + d * wx;
        const float v = (top * (1.0f - wy) + bot * wy) / scale;
        dst[oy * out_hw + ox] = (v - m) * inv_s;
      }
    }
  }
}

}  // extern "C"
