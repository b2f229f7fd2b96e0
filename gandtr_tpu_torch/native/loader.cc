// gandtr_tpu_torch native image loader: GIL-free JPEG/PNG decode + C++
// worker pool (the port's own copy of the JAX package's loader, ABI 1).
//
// The reference feeds its models through torch's DataLoader, whose real engine
// is native worker processes (mdir/learning/dataset.py initialize_loader,
// num_workers 6).  Here the decode runs in C++:
//   - libjpeg decode with DCT-domain scaling (scale_num/denom) so eval-protocol
//     images (longest side 1024) never decode at full camera resolution;
//   - libpng decode (palette/gray/alpha normalized to RGB8);
//   - a std::thread worker pool with a condition-variable work queue, so batch
//     decode runs fully outside the Python GIL (ctypes releases it per call).
//
// Exposed as a plain C API consumed by gandtr_tpu_torch/native/__init__.py
// (ctypes), which builds it with g++ at first use.  Every function returns 0
// on success / nonzero error codes; failures leave the caller free to fall
// back to the PIL path (reference semantics: image load faults degrade, not
// crash -- genericdataset.py:74-81).

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <cstdint>

#include <atomic>
#include <condition_variable>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

extern "C" {

// ---------------------------------------------------------------- error codes
enum {
  GANDTR_OK = 0,
  GANDTR_E_OPEN = 1,        // cannot open file
  GANDTR_E_FORMAT = 2,      // not a JPEG/PNG (caller should use PIL)
  GANDTR_E_DECODE = 3,      // decoder error mid-stream
  GANDTR_E_UNSUPPORTED = 4, // colorspace we do not normalize (e.g. CMYK)
  GANDTR_E_NOMEM = 5,
};

// ------------------------------------------------------------- jpeg plumbing
struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

static void jpeg_error_exit_cb(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

static void jpeg_output_message_cb(j_common_ptr) {}  // silence warnings

// Decode a JPEG file to tightly-packed RGB8.  If scale_longest > 0, pick the
// largest libjpeg DCT scale (8/8 .. 1/8) whose longest output side is still
// >= scale_longest (PIL Image.draft semantics): downstream resampling then
// starts from the smallest faithful raster.
static int decode_jpeg(FILE* f, uint8_t** out, int* h, int* w,
                       int scale_longest) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit_cb;
  jerr.pub.output_message = jpeg_output_message_cb;
  // volatile: modified between setjmp and a decoder-error longjmp — a plain
  // local's value would be indeterminate in the handler (free of garbage)
  uint8_t* volatile buf = nullptr;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    free(buf);
    return GANDTR_E_DECODE;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);

  if (cinfo.jpeg_color_space == JCS_CMYK ||
      cinfo.jpeg_color_space == JCS_YCCK) {
    jpeg_destroy_decompress(&cinfo);
    return GANDTR_E_UNSUPPORTED;
  }
  cinfo.out_color_space = JCS_RGB;  // libjpeg expands grayscale to RGB

  if (scale_longest > 0) {
    const long full = (cinfo.image_width > cinfo.image_height)
                          ? cinfo.image_width : cinfo.image_height;
    cinfo.scale_num = 8;
    cinfo.scale_denom = 8;
    for (int num = 8; num >= 1; --num) {
      // ceil(full * num / 8): libjpeg rounds scaled dimensions up
      const long side = (full * num + 7) / 8;
      if (side >= scale_longest) {
        cinfo.scale_num = num;
      } else {
        break;
      }
    }
  }

  jpeg_start_decompress(&cinfo);
  const int W = cinfo.output_width, H = cinfo.output_height;
  const int C = cinfo.output_components;
  if (C != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return GANDTR_E_UNSUPPORTED;
  }
  buf = static_cast<uint8_t*>(malloc(static_cast<size_t>(W) * H * 3));
  if (!buf) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return GANDTR_E_NOMEM;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = buf + static_cast<size_t>(cinfo.output_scanline) * W * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out = buf;
  *h = H;
  *w = W;
  return GANDTR_OK;
}

// -------------------------------------------------------------- png plumbing
static int decode_png(FILE* f, uint8_t** out, int* h, int* w) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return GANDTR_E_NOMEM;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return GANDTR_E_NOMEM;
  }
  // volatile for the same setjmp/longjmp reason as decode_jpeg; rows are
  // read one at a time (no row-pointer vector mutated after setjmp)
  uint8_t* volatile buf = nullptr;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    free(buf);
    return GANDTR_E_DECODE;
  }
  png_init_io(png, f);
  png_read_info(png, info);

  // Normalize every PNG layout to 8-bit RGB (PIL convert("RGB") parity:
  // palette expansion, gray->RGB, 16->8 bit strip, alpha dropped against
  // nothing — PIL's convert simply discards alpha).
  png_byte color_type = png_get_color_type(png, info);
  png_byte bit_depth = png_get_bit_depth(png, info);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color_type & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS))
    // tRNS would expand to an alpha channel; strip it the same way
    png_set_strip_alpha(png);
  // row-at-a-time reading below needs explicit interlace passes
  const int passes = png_set_interlace_handling(png);
  png_read_update_info(png, info);

  const int W = png_get_image_width(png, info);
  const int H = png_get_image_height(png, info);
  if (png_get_rowbytes(png, info) != static_cast<size_t>(W) * 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return GANDTR_E_UNSUPPORTED;
  }
  buf = static_cast<uint8_t*>(malloc(static_cast<size_t>(W) * H * 3));
  if (!buf) {
    png_destroy_read_struct(&png, &info, nullptr);
    return GANDTR_E_NOMEM;
  }
  for (int p = 0; p < passes; ++p)
    for (int y = 0; y < H; ++y)
      png_read_row(png, buf + static_cast<size_t>(y) * W * 3, nullptr);
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  *out = buf;
  *h = H;
  *w = W;
  return GANDTR_OK;
}

// ------------------------------------------------------------------ dispatch
// Decode `path` into a malloc'd RGB8 buffer (*out, freed by gandtr_free).
int gandtr_decode(const char* path, uint8_t** out, int* h, int* w,
                  int scale_longest) {
  *out = nullptr;
  FILE* f = fopen(path, "rb");
  if (!f) return GANDTR_E_OPEN;
  unsigned char magic[8] = {0};
  const size_t got = fread(magic, 1, 8, f);
  rewind(f);
  int rc;
  if (got >= 3 && magic[0] == 0xFF && magic[1] == 0xD8 && magic[2] == 0xFF) {
    rc = decode_jpeg(f, out, h, w, scale_longest);
  } else if (got >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    rc = decode_png(f, out, h, w);
  } else {
    rc = GANDTR_E_FORMAT;
  }
  fclose(f);
  return rc;
}

void gandtr_free(uint8_t* buf) { free(buf); }

// ----------------------------------------------------------------- work pool
struct BatchState {
  int remaining;  // guarded by Pool::mu
};

struct DecodeTask {
  const char* path;
  uint8_t** out;
  int* h;
  int* w;
  int scale_longest;
  int* rc;
  BatchState* batch;
};

struct Pool {
  std::vector<std::thread> threads;
  std::queue<DecodeTask> queue;
  std::mutex mu;
  std::condition_variable cv;       // workers wait for tasks
  std::condition_variable done_cv;  // batch calls wait for THEIR tasks
  bool stop = false;

  explicit Pool(int n) {
    for (int i = 0; i < n; ++i)
      threads.emplace_back([this] { worker(); });
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv.notify_all();
    for (auto& t : threads) t.join();
  }

  void worker() {
    for (;;) {
      DecodeTask task;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [this] { return stop || !queue.empty(); });
        if (stop && queue.empty()) return;
        task = queue.front();
        queue.pop();
      }
      *task.rc = gandtr_decode(task.path, task.out, task.h, task.w,
                               task.scale_longest);
      {
        std::lock_guard<std::mutex> lk(mu);
        // per-batch counter: concurrent run_batch callers on a shared pool
        // each wake when THEIR tasks drain, not when the whole queue does
        if (--task.batch->remaining == 0) done_cv.notify_all();
      }
    }
  }

  void run_batch(DecodeTask* tasks, int n) {
    BatchState batch{n};  // outlives the wait below, so queue copies of the
                          // pointer stay valid for the workers
    {
      std::lock_guard<std::mutex> lk(mu);
      for (int i = 0; i < n; ++i) {
        tasks[i].batch = &batch;
        queue.push(tasks[i]);
      }
    }
    cv.notify_all();
    std::unique_lock<std::mutex> lk(mu);
    done_cv.wait(lk, [&batch] { return batch.remaining == 0; });
  }
};

void* gandtr_pool_create(int n_threads) {
  if (n_threads < 1) n_threads = 1;
  return new Pool(n_threads);
}

void gandtr_pool_destroy(void* pool) { delete static_cast<Pool*>(pool); }

// Decode n images concurrently on the pool.  outs[i] receive malloc'd RGB8
// buffers (or nullptr on failure; rcs[i] has the per-image error code).  The
// call blocks until the whole batch drained — from Python this is ONE ctypes
// call, so the entire batch decodes with the GIL released.
void gandtr_pool_decode_batch(void* pool, const char** paths, int n,
                              uint8_t** outs, int* hs, int* ws,
                              int scale_longest, int* rcs) {
  std::vector<DecodeTask> tasks(n);
  for (int i = 0; i < n; ++i) {
    outs[i] = nullptr;
    tasks[i] = DecodeTask{paths[i], &outs[i], &hs[i], &ws[i], scale_longest,
                          &rcs[i]};
  }
  static_cast<Pool*>(pool)->run_batch(tasks.data(), n);
}

int gandtr_native_abi_version() { return 1; }

}  // extern "C"
