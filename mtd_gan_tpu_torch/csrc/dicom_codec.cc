// Native DICOM -> HU decoder (C ABI, ctypes-loaded): the port's own copy of
// the JAX package's native/dicom_codec.cc.
//
// Parses Part-10 / raw DICOM datasets (explicit & implicit VR little endian,
// uncompressed 16-bit PixelData), applies the modality rescale (slope /
// intercept) and the -2000 air sentinel, and emits int16 HU: the exact
// semantics of mtd_gan_tpu_torch.data.dicom.get_pixels_hu (reference
// create_datasets/Mayo.py:19-43). Called through ctypes, the decode releases
// the GIL, so the loader's threads overlap decode with device compute.
//
// Built on first use by mtd_gan_tpu_torch/ops/_build.py (build_host):
// g++ -O3 -shared -fPIC into mtd_gan_tpu_torch/_build/.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>

namespace {

constexpr uint32_t kUndefined = 0xFFFFFFFFu;

struct Cursor {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;

  bool ok(size_t need) const { return pos + need <= n; }
  uint16_t u16() { uint16_t v; std::memcpy(&v, p + pos, 2); pos += 2; return v; }
  uint32_t u32() { uint32_t v; std::memcpy(&v, p + pos, 4); pos += 4; return v; }
};

bool is_long_vr(const uint8_t* vr) {
  static const char* kLong[] = {"OB", "OW", "OF", "OD", "OL",
                                "SQ", "UC", "UR", "UT", "UN"};
  for (const char* s : kLong)
    if (vr[0] == s[0] && vr[1] == s[1]) return true;
  return false;
}

double parse_ds(const uint8_t* v, uint32_t len) {
  char buf[64];
  uint32_t m = len < 63 ? len : 63;
  std::memcpy(buf, v, m);
  buf[m] = 0;
  return std::strtod(buf, nullptr);
}

void skip_undefined_item(Cursor& c);

void skip_undefined_sequence(Cursor& c) {
  while (c.ok(8)) {
    uint16_t g = c.u16(), e = c.u16();
    uint32_t len = c.u32();
    if (g == 0xFFFE && e == 0xE0DD) return;  // sequence delimiter
    if (g == 0xFFFE && e == 0xE000 && len == kUndefined) {
      skip_undefined_item(c);
    } else {
      c.pos += len;
    }
  }
}

void skip_undefined_item(Cursor& c) {
  while (c.ok(8)) {
    uint16_t g = c.u16(), e = c.u16();
    uint32_t len = c.u32();
    if (g == 0xFFFE && e == 0xE00D) return;  // item delimiter
    if (len != kUndefined) c.pos += len;
  }
}

struct Header {
  int rows = 0, cols = 0;
  int bits_allocated = 16;
  int pixel_representation = 0;
  double slope = 1.0, intercept = 0.0;
  const uint8_t* pixel = nullptr;
  uint32_t pixel_len = 0;
};

// returns 0 on success
int parse_dataset(Cursor& c, bool explicit_vr, uint16_t stop_group,
                  Header* h, char* transfer_syntax, size_t ts_cap) {
  while (c.ok(8)) {
    size_t tag_pos = c.pos;
    uint16_t g = c.u16(), e = c.u16();
    if (stop_group && g > stop_group) {
      c.pos = tag_pos;
      return 0;
    }
    uint32_t len;
    const uint8_t* vr = c.p + c.pos;
    if (explicit_vr && g != 0xFFFE) {
      if (is_long_vr(vr)) {
        c.pos += 4;  // vr + reserved
        if (!c.ok(4)) return 1;
        len = c.u32();
      } else {
        c.pos += 2;
        if (!c.ok(2)) return 1;
        len = c.u16();
      }
    } else {
      if (!c.ok(4)) return 1;
      len = c.u32();
    }
    if (len == kUndefined) {
      skip_undefined_sequence(c);
      continue;
    }
    if (!c.ok(len)) return 1;
    const uint8_t* val = c.p + c.pos;

    if (g == 0x0002 && e == 0x0010 && transfer_syntax) {
      size_t m = len < ts_cap - 1 ? len : ts_cap - 1;
      std::memcpy(transfer_syntax, val, m);
      transfer_syntax[m] = 0;
      // strip trailing nulls/spaces
      while (m && (transfer_syntax[m - 1] == 0 || transfer_syntax[m - 1] == ' '))
        transfer_syntax[--m] = 0;
    } else if (g == 0x0028) {
      switch (e) {
        case 0x0010: h->rows = *(const uint16_t*)val; break;
        case 0x0011: h->cols = *(const uint16_t*)val; break;
        case 0x0100: h->bits_allocated = *(const uint16_t*)val; break;
        case 0x0103: h->pixel_representation = *(const uint16_t*)val; break;
        case 0x1052: h->intercept = parse_ds(val, len); break;
        case 0x1053: h->slope = parse_ds(val, len); break;
        default: break;
      }
    } else if (g == 0x7FE0 && e == 0x0010) {
      h->pixel = val;
      h->pixel_len = len;
    }
    c.pos += len;
  }
  return 0;
}

}  // namespace

extern "C" {

// Decode one DICOM buffer to int16 HU. Returns 0 on success; fills rows/cols.
// out must have capacity out_capacity int16 elements.
int dicom_decode_hu(const uint8_t* buf, size_t len, int16_t* out,
                    size_t out_capacity, int* rows, int* cols) {
  Cursor c{buf, len};
  char ts[64] = "1.2.840.10008.1.2.1";
  Header h;

  bool explicit_vr = true;
  if (len > 132 && std::memcmp(buf + 128, "DICM", 4) == 0) {
    c.pos = 132;
    if (parse_dataset(c, /*explicit_vr=*/true, /*stop_group=*/0x0002, &h, ts,
                      sizeof(ts)) != 0)
      return -1;
  }
  if (std::strcmp(ts, "1.2.840.10008.1.2") == 0) {
    explicit_vr = false;
  } else if (std::strcmp(ts, "1.2.840.10008.1.2.1") != 0) {
    return -2;  // unsupported transfer syntax
  }
  if (parse_dataset(c, explicit_vr, 0, &h, nullptr, 0) != 0) return -1;
  if (!h.pixel || h.bits_allocated != 16) return -3;
  size_t npix = (size_t)h.rows * h.cols;
  if (npix == 0 || npix > out_capacity || h.pixel_len < npix * 2) return -4;

  *rows = h.rows;
  *cols = h.cols;
  const bool is_signed = h.pixel_representation == 1;
  const double slope = h.slope, intercept = h.intercept;
  const int16_t i_intercept = (int16_t)intercept;

  // reference semantics (Mayo.py:30-42): int16 cast, -2000 -> 0,
  // slope applied in double then truncated to int16, + int16(intercept)
  for (size_t i = 0; i < npix; ++i) {
    int16_t v;
    if (is_signed) {
      std::memcpy(&v, h.pixel + 2 * i, 2);
    } else {
      uint16_t u;
      std::memcpy(&u, h.pixel + 2 * i, 2);
      v = (int16_t)u;
    }
    if (v == -2000) v = 0;
    if (slope != 1.0) v = (int16_t)(slope * (double)v);
    out[i] = (int16_t)(v + i_intercept);
  }
  return 0;
}

}  // extern "C"
