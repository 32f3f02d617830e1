// Native data loader: minimal PNG decode + multithreaded batch prefetch.
//
// The reference delegates all image IO to OpenCV (cv::VideoCapture /
// cv::imread in examples/*); this framework's runtime carries its own
// dependency-free native loader so the host-side input pipeline (decode +
// prefetch of stereo pairs) keeps the TPU fed without OpenCV. Exposed as a
// C ABI consumed via ctypes (lvt_tpu/io/native_loader.py).
//
// Supports the PNG subset the datasets use: 8/16-bit greyscale, 8-bit
// RGB/RGBA/palette, all five scanline filters, single IDAT stream (and
// concatenated IDATs), no interlacing. zlib does the inflate.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

struct PngImage {
  int width = 0;
  int height = 0;
  int channels = 0;   // after palette expansion
  int bit_depth = 0;  // 8 or 16
  std::vector<uint8_t> pixels;  // row-major, 16-bit stays big-endian-decoded
};

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

bool decode_png(const uint8_t* data, size_t size, PngImage* out) {
  static const uint8_t kMagic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (size < 8 || std::memcmp(data, kMagic, 8) != 0) return false;

  size_t pos = 8;
  int color_type = -1;
  std::vector<uint8_t> idat;
  std::vector<uint8_t> palette;  // RGB triples
  int width = 0, height = 0, bit_depth = 0;

  while (pos + 8 <= size) {
    uint32_t len = be32(data + pos);
    const uint8_t* type = data + pos + 4;
    const uint8_t* body = data + pos + 8;
    if (pos + 12 + len > size) return false;

    if (!std::memcmp(type, "IHDR", 4)) {
      if (len < 13) return false;
      width = int(be32(body));
      height = int(be32(body + 4));
      bit_depth = body[8];
      color_type = body[9];
      if (body[12] != 0) return false;  // interlaced unsupported
      if (bit_depth != 8 && bit_depth != 16) return false;
    } else if (!std::memcmp(type, "PLTE", 4)) {
      palette.assign(body, body + len);
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + len);
    } else if (!std::memcmp(type, "IEND", 4)) {
      break;
    }
    pos += 12 + len;
  }
  if (width <= 0 || height <= 0 || idat.empty()) return false;

  int src_channels;
  switch (color_type) {
    case 0: src_channels = 1; break;  // grey
    case 2: src_channels = 3; break;  // rgb
    case 3: src_channels = 1; break;  // palette index
    case 4: src_channels = 2; break;  // grey+alpha
    case 6: src_channels = 4; break;  // rgba
    default: return false;
  }
  if (color_type == 3 && (palette.empty() || bit_depth != 8)) return false;

  const int bytes_per_sample = bit_depth / 8;
  const size_t stride = size_t(width) * src_channels * bytes_per_sample;
  std::vector<uint8_t> raw((stride + 1) * height);

  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = idat.data();
  zs.avail_in = uInt(idat.size());
  zs.next_out = raw.data();
  zs.avail_out = uInt(raw.size());
  int zret = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  if (zret != Z_STREAM_END && zret != Z_OK) return false;

  // undo scanline filters in place into `img`
  const int bpp = src_channels * bytes_per_sample;
  std::vector<uint8_t> img(stride * height);
  const uint8_t* prev = nullptr;
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = raw.data() + size_t(y) * (stride + 1);
    uint8_t filter = src[0];
    ++src;
    uint8_t* dst = img.data() + size_t(y) * stride;
    switch (filter) {
      case 0:
        std::memcpy(dst, src, stride);
        break;
      case 1:  // Sub
        for (size_t i = 0; i < stride; ++i)
          dst[i] = uint8_t(src[i] + (i >= size_t(bpp) ? dst[i - bpp] : 0));
        break;
      case 2:  // Up
        for (size_t i = 0; i < stride; ++i)
          dst[i] = uint8_t(src[i] + (prev ? prev[i] : 0));
        break;
      case 3:  // Average
        for (size_t i = 0; i < stride; ++i) {
          int a = i >= size_t(bpp) ? dst[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          dst[i] = uint8_t(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (size_t i = 0; i < stride; ++i) {
          int a = i >= size_t(bpp) ? dst[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          int c = (prev && i >= size_t(bpp)) ? prev[i - bpp] : 0;
          dst[i] = uint8_t(src[i] + paeth(a, b, c));
        }
        break;
      default:
        return false;
    }
    prev = dst;
  }

  // palette expansion
  if (color_type == 3) {
    out->pixels.resize(size_t(width) * height * 3);
    for (size_t i = 0; i < size_t(width) * height; ++i) {
      const uint8_t* rgb = &palette[size_t(img[i]) * 3];
      out->pixels[i * 3 + 0] = rgb[0];
      out->pixels[i * 3 + 1] = rgb[1];
      out->pixels[i * 3 + 2] = rgb[2];
    }
    out->channels = 3;
    out->bit_depth = 8;
  } else {
    if (bit_depth == 16) {
      // big-endian -> host-order uint16
      out->pixels.resize(img.size());
      for (size_t i = 0; i + 1 < img.size(); i += 2) {
        uint16_t v = uint16_t((img[i] << 8) | img[i + 1]);
        std::memcpy(&out->pixels[i], &v, 2);
      }
    } else {
      out->pixels = std::move(img);
    }
    out->channels = src_channels;
    out->bit_depth = bit_depth;
  }
  out->width = width;
  out->height = height;
  return true;
}

bool read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n <= 0) {
    std::fclose(f);
    return false;
  }
  buf->resize(size_t(n));
  size_t got = std::fread(buf->data(), 1, size_t(n), f);
  std::fclose(f);
  return got == size_t(n);
}

bool load_png_file(const char* path, PngImage* img) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return false;
  return decode_png(buf.data(), buf.size(), img);
}

}  // namespace

extern "C" {

// Probe image dimensions. Returns 0 on success.
int lvt_png_probe(const char* path, int* width, int* height, int* channels,
                  int* bit_depth) {
  PngImage img;
  if (!load_png_file(path, &img)) return -1;
  *width = img.width;
  *height = img.height;
  *channels = img.channels;
  *bit_depth = img.bit_depth;
  return 0;
}

// Decode into caller-provided buffer of size w*h*channels*(bit_depth/8).
int lvt_png_read(const char* path, uint8_t* out, int64_t out_size) {
  PngImage img;
  if (!load_png_file(path, &img)) return -1;
  if (int64_t(img.pixels.size()) > out_size) return -2;
  std::memcpy(out, img.pixels.data(), img.pixels.size());
  return 0;
}

// Decode to 8-bit greyscale (BT.601 luma for color inputs, 16-bit scaled
// down) into out[w*h]. This is the hot path for the VO datasets.
int lvt_png_read_gray(const char* path, uint8_t* out, int64_t out_size) {
  PngImage img;
  if (!load_png_file(path, &img)) return -1;
  int64_t n = int64_t(img.width) * img.height;
  if (n > out_size) return -2;
  if (img.channels == 1 && img.bit_depth == 8) {
    std::memcpy(out, img.pixels.data(), size_t(n));
  } else if (img.channels == 1 && img.bit_depth == 16) {
    const uint16_t* p = reinterpret_cast<const uint16_t*>(img.pixels.data());
    for (int64_t i = 0; i < n; ++i) out[i] = uint8_t(p[i] >> 8);
  } else if (img.bit_depth == 8) {
    int c = img.channels;
    for (int64_t i = 0; i < n; ++i) {
      const uint8_t* px = &img.pixels[size_t(i) * c];
      out[i] = uint8_t((299 * px[0] + 587 * px[1] + 114 * px[2] + 500) / 1000);
    }
  } else {
    return -3;
  }
  return 0;
}

// Batch greyscale decode with a thread pool: the prefetch path that keeps
// the device fed while it tracks the previous chunk.
int lvt_png_read_gray_batch(const char** paths, int n_paths, uint8_t* out,
                            int64_t frame_size, int n_threads) {
  if (n_threads <= 0) n_threads = int(std::thread::hardware_concurrency());
  if (n_threads <= 0) n_threads = 2;
  std::vector<int> status(size_t(n_paths), 0);
  std::vector<std::thread> workers;
  std::atomic_int next_idx{0};
  for (int t = 0; t < n_threads && t < n_paths; ++t) {
    workers.emplace_back([&]() {
      for (int i = next_idx.fetch_add(1); i < n_paths;
           i = next_idx.fetch_add(1)) {
        status[size_t(i)] = lvt_png_read_gray(
            paths[i], out + int64_t(i) * frame_size, frame_size);
      }
    });
  }
  for (auto& w : workers) w.join();
  for (int s : status)
    if (s != 0) return s;
  return 0;
}

}  // extern "C"
