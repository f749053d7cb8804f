// plslam_tpu_torch native dataset loader.
//
// A copy of the JAX package's `native/plslam_loader.cpp`, so the port stands
// alone.
//
// The reference's example drivers block the tracking loop on cv::imread
// (Examples/Monocular/mono_tum.cc:85-91). This library decodes PNG/JPEG/PGM
// frames to grayscale on background threads into a ring of reusable buffers
// so the Python host loop (and the GPU) never waits on disk/decode.
//
// C ABI (ctypes-friendly):
//   loader_create(paths, n_paths, queue_depth, n_threads) -> handle
//   loader_next(handle, out_buf, cap, &w, &h) -> 0 ok / <0 error, blocks
//   loader_destroy(handle)
//   decode_gray(path, out_buf, cap, &w, &h) -> one-shot decode
//
// Build: g++ -O3 -shared -fPIC plslam_loader.cpp -lpng -ljpeg -lz -lpthread
// (`plslam_tpu_torch/utils/native_loader.py` builds it at first use)

#include <png.h>
#include <jpeglib.h>

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  std::vector<uint8_t> data;
  int w = 0, h = 0;
  bool ok = false;
};

bool decode_png(const char* path, Image* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return false;
  }
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  int w = png_get_image_width(png, info);
  int h = png_get_image_height(png, info);
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);

  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE)
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  png_read_update_info(png, info);

  out->w = w;
  out->h = h;
  out->data.resize((size_t)w * h);
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; ++y) rows[y] = out->data.data() + (size_t)y * w;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  out->ok = true;
  return true;
}

bool decode_jpeg(const char* path, Image* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return false;
  }
  cinfo.out_color_space = JCS_GRAYSCALE;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->data.resize((size_t)out->w * out->h);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out->data.data() + (size_t)cinfo.output_scanline * out->w;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(fp);
  out->ok = true;
  return true;
}

bool decode_pgm(const char* path, Image* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  char magic[3] = {0};
  int w, h, maxv;
  if (std::fscanf(fp, "%2s %d %d %d", magic, &w, &h, &maxv) != 4 ||
      std::strcmp(magic, "P5") != 0 || maxv > 255) {
    std::fclose(fp);
    return false;
  }
  std::fgetc(fp);  // single whitespace after header
  out->w = w;
  out->h = h;
  out->data.resize((size_t)w * h);
  bool ok = std::fread(out->data.data(), 1, (size_t)w * h, fp) == (size_t)w * h;
  std::fclose(fp);
  out->ok = ok;
  return ok;
}

bool decode_any(const std::string& path, Image* out) {
  auto dot = path.find_last_of('.');
  std::string ext = dot == std::string::npos ? "" : path.substr(dot + 1);
  for (auto& c : ext) c = (char)tolower(c);
  if (ext == "png") return decode_png(path.c_str(), out);
  if (ext == "jpg" || ext == "jpeg") return decode_jpeg(path.c_str(), out);
  if (ext == "pgm") return decode_pgm(path.c_str(), out);
  // try by magic
  return decode_png(path.c_str(), out) || decode_jpeg(path.c_str(), out) ||
         decode_pgm(path.c_str(), out);
}

struct Loader {
  std::vector<std::string> paths;
  size_t queue_depth;
  std::deque<Image> ready;           // decoded, in order
  size_t next_to_decode = 0;         // producer index
  size_t next_to_emit = 0;           // consumer index
  size_t emitted_from_ready = 0;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  // decode-in-order with multiple threads: each worker claims an index and
  // inserts at its slot; simple approach — slot map
  std::vector<Image> slots;
  std::vector<uint8_t> slot_done;

  explicit Loader(std::vector<std::string> p, size_t depth, int n_threads)
      : paths(std::move(p)), queue_depth(depth) {
    slots.resize(paths.size());
    slot_done.assign(paths.size(), 0);
    for (int t = 0; t < n_threads; ++t)
      workers.emplace_back([this] { run(); });
  }

  void run() {
    for (;;) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stop || (next_to_decode < paths.size() &&
                          next_to_decode < next_to_emit + queue_depth);
        });
        if (stop || next_to_decode >= paths.size()) return;
        idx = next_to_decode++;
      }
      Image im;
      decode_any(paths[idx], &im);
      {
        std::lock_guard<std::mutex> lk(mu);
        slots[idx] = std::move(im);
        slot_done[idx] = 1;
      }
      cv_ready.notify_all();
    }
  }

  int next(uint8_t* out, int64_t cap, int* w, int* h) {
    std::unique_lock<std::mutex> lk(mu);
    if (next_to_emit >= paths.size()) return -1;  // exhausted
    size_t idx = next_to_emit;
    cv_ready.wait(lk, [&] { return stop || slot_done[idx]; });
    if (stop) return -2;
    Image& im = slots[idx];
    if (!im.ok) {
      next_to_emit++;
      cv_space.notify_all();
      return -3;
    }
    if ((int64_t)im.data.size() > cap) return -4;
    std::memcpy(out, im.data.data(), im.data.size());
    *w = im.w;
    *h = im.h;
    im.data.clear();
    im.data.shrink_to_fit();
    next_to_emit++;
    cv_space.notify_all();
    return 0;
  }

  ~Loader() {
    stop = true;
    cv_space.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers) t.join();
  }
};

}  // namespace

extern "C" {

void* loader_create(const char** paths, int n_paths, int queue_depth,
                    int n_threads) {
  std::vector<std::string> p(paths, paths + n_paths);
  return new Loader(std::move(p), (size_t)queue_depth, n_threads);
}

int loader_next(void* handle, uint8_t* out, int64_t cap, int* w, int* h) {
  return static_cast<Loader*>(handle)->next(out, cap, w, h);
}

void loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

int decode_gray(const char* path, uint8_t* out, int64_t cap, int* w, int* h) {
  Image im;
  if (!decode_any(path, &im)) return -1;
  if ((int64_t)im.data.size() > cap) return -4;
  std::memcpy(out, im.data.data(), im.data.size());
  *w = im.w;
  *h = im.h;
  return 0;
}

}  // extern "C"
