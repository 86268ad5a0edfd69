// Threaded JPEG batch decoder for the frame-directory input path.
//
// The reference decodes frames inside torch dataloader worker PROCESSES
// (datasets/vidstg.py:143-150 Image.open per frame); this framework's
// loader uses threads, so decode must not hold the GIL and must be fast on
// few cores: libjpeg straight into the caller's [n, h, w, 3] uint8 buffer,
// entirely outside the GIL (ctypes releases it around the call).
//
// API (ctypes, data/jpeg_decode.py):
//   jp_decode_batch(paths, n, out, h, w, workers) -> number of failures
//     paths: n concatenated NUL-terminated file paths
//     out:   caller-allocated n*h*w*3 bytes; frame i at offset i*h*w*3
//     a file whose decoded dimensions differ from (w, h) counts as failure
//
// Build: g++ -O2 -fPIC -shared jpegpool.cc -o libjpegpool-<hash>.so -ljpeg -lpthread,
// at first use, into stcat_tpu_torch/_build/ (kernels/_build.py:build_native).

#include <atomic>
#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// decode one file into dst ([h, w, 3] RGB); returns 0 on success
int decode_file(const char* path, unsigned char* dst, long h, long w) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;

  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<long>(cinfo.output_width) != w ||
      static_cast<long>(cinfo.output_height) != h) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 1;
  }
  const long stride = w * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = dst + static_cast<long>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return 0;
}

// decode one file into planar 4:2:0 -- dst_y [h, w] luma, dst_c
// [(h+1)/2, (w+1)/2, 2] interleaved CbCr (2x2 box-averaged, which matches
// JFIF chroma siting: plane sample j centered at luma coordinate 2j+0.5).
// JPEGs store YCbCr, so JCS_YCbCr skips libjpeg's RGB color transform; the
// box subsample hands the wire 1.5 bytes/pixel instead of 3. Returns 0 ok.
int decode_file_yuv(const char* path, unsigned char* dst_y,
                    unsigned char* dst_c, long h, long w) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;

  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_YCbCr;
  jpeg_start_decompress(&cinfo);
  if (static_cast<long>(cinfo.output_width) != w ||
      static_cast<long>(cinfo.output_height) != h ||
      cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 1;
  }
  const long wc = (w + 1) / 2;
  std::vector<unsigned char> row(w * 3);
  std::vector<unsigned short> acc(wc * 2);   // cb,cr sums of the row pair
  std::vector<unsigned short> cnt(wc * 2);   // contributing samples
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* rp = row.data();
    jpeg_read_scanlines(&cinfo, &rp, 1);
    const long yy = static_cast<long>(cinfo.output_scanline) - 1;
    unsigned char* yrow = dst_y + yy * w;
    if ((yy & 1) == 0) {
      std::memset(acc.data(), 0, acc.size() * sizeof(acc[0]));
      std::memset(cnt.data(), 0, cnt.size() * sizeof(cnt[0]));
    }
    for (long x = 0; x < w; ++x) {
      yrow[x] = row[x * 3];
      const long xc = x >> 1;
      acc[xc * 2 + 0] += row[x * 3 + 1];
      acc[xc * 2 + 1] += row[x * 3 + 2];
      cnt[xc * 2 + 0] += 1;
      cnt[xc * 2 + 1] += 1;
    }
    if ((yy & 1) == 1 || yy == h - 1) {
      unsigned char* crow = dst_c + (yy >> 1) * wc * 2;
      for (long k = 0; k < wc * 2; ++k) {
        crow[k] = static_cast<unsigned char>(
            (acc[k] + cnt[k] / 2) / cnt[k]);
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return 0;
}

}  // namespace

extern "C" long jp_decode_batch_yuv(const char* paths, long n,
                                    unsigned char* out_y, unsigned char* out_c,
                                    long h, long w, long workers) {
  std::vector<const char*> files;
  files.reserve(n);
  const char* p = paths;
  for (long i = 0; i < n; ++i) {
    files.push_back(p);
    p += std::strlen(p) + 1;
  }
  const long y_bytes = h * w;
  const long c_bytes = ((h + 1) / 2) * ((w + 1) / 2) * 2;
  std::atomic<long> next(0), failures(0);

  auto work = [&]() {
    for (;;) {
      long i = next.fetch_add(1);
      if (i >= n) break;
      if (decode_file_yuv(files[i], out_y + i * y_bytes, out_c + i * c_bytes,
                          h, w)) {
        failures.fetch_add(1);
      }
    }
  };

  if (workers <= 1) {
    work();
  } else {
    std::vector<std::thread> threads;
    long nt = workers < n ? workers : n;
    for (long i = 0; i < nt; ++i) threads.emplace_back(work);
    for (auto& t : threads) t.join();
  }
  return failures.load();
}

extern "C" long jp_decode_batch(const char* paths, long n, unsigned char* out,
                                long h, long w, long workers) {
  std::vector<const char*> files;
  files.reserve(n);
  const char* p = paths;
  for (long i = 0; i < n; ++i) {
    files.push_back(p);
    p += std::strlen(p) + 1;
  }
  const long frame_bytes = h * w * 3;
  std::atomic<long> next(0), failures(0);

  auto work = [&]() {
    for (;;) {
      long i = next.fetch_add(1);
      if (i >= n) break;
      if (decode_file(files[i], out + i * frame_bytes, h, w)) {
        failures.fetch_add(1);
      }
    }
  };

  if (workers <= 1) {
    work();
  } else {
    std::vector<std::thread> threads;
    long nt = workers < n ? workers : n;
    for (long i = 0; i < nt; ++i) threads.emplace_back(work);
    for (auto& t : threads) t.join();
  }
  return failures.load();
}
