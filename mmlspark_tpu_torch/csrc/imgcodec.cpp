// Image decode of the PyTorch port: the port's copy of mml_decode_image
// of mmlspark_tpu/native/src/mml_native.cpp (JPEG through libjpeg, PNG
// through libpng's simplified API, sniffed by their magic bytes), with the
// same RGB8 output. Linked with -ljpeg -lpng, so it is built apart from the
// other host libraries, the first time a decode needs it (a machine may
// lack the two libraries' headers); see mmlspark_tpu_torch/_build.py and
// io/native_image.py, which binds it with ctypes.

#include <csetjmp>
#include <cstdint>
#include <cstdio>  // jpeglib.h needs FILE declared first
#include <cstdlib>
#include <cstring>

#include <jpeglib.h>
#include <png.h>

extern "C" {

// frees a buffer that mml_decode_image allocated
void mml_free(void* p) { std::free(p); }

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// decode JPEG bytes -> RGB8 buffer (caller frees with mml_free)
static int decode_jpeg(const uint8_t* data, int len, uint8_t** out,
                       int* h, int* w, int* c) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  // volatile: modified between setjmp and longjmp; without it the value
  // read in the error path is indeterminate (UB) on malformed input
  uint8_t* volatile buf = nullptr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    std::free(buf);
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int H = cinfo.output_height, W = cinfo.output_width;
  const int C = cinfo.output_components;  // 3 for JCS_RGB
  buf = static_cast<uint8_t*>(
      std::malloc(static_cast<size_t>(H) * W * C));
  if (!buf) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = buf + static_cast<size_t>(cinfo.output_scanline) * W * C;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out = buf;
  *h = H;
  *w = W;
  *c = C;
  return 0;
}

// decode PNG bytes -> RGB8 (libpng simplified API)
static int decode_png(const uint8_t* data, int len, uint8_t** out,
                      int* h, int* w, int* c) {
  png_image image;
  std::memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&image, data,
                                        static_cast<size_t>(len))) {
    return -1;
  }
  image.format = PNG_FORMAT_RGB;
  const size_t size = PNG_IMAGE_SIZE(image);
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(size));
  if (!buf) {
    png_image_free(&image);
    return -2;
  }
  if (!png_image_finish_read(&image, nullptr, buf, 0, nullptr)) {
    std::free(buf);
    png_image_free(&image);
    return -1;
  }
  *out = buf;
  *h = static_cast<int>(image.height);
  *w = static_cast<int>(image.width);
  *c = 3;
  return 0;
}

// sniff magic bytes, decode jpeg/png -> RGB8
int mml_decode_image(const uint8_t* data, int len, uint8_t** out,
                     int* h, int* w, int* c) {
  if (len >= 3 && data[0] == 0xFF && data[1] == 0xD8 && data[2] == 0xFF) {
    return decode_jpeg(data, len, out, h, w, c);
  }
  if (len >= 8 && data[0] == 0x89 && data[1] == 'P' && data[2] == 'N' &&
      data[3] == 'G') {
    return decode_png(data, len, out, h, w, c);
  }
  return -3;  // unknown format
}

}  // extern "C"
