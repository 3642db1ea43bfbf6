/* A JPEG writer over libjpeg-turbo (the library Pillow bundles), for the port's JPEG tests:
 * the kinds Pillow's save() cannot write. Built by tests/torch_jpeg_writer.py against the
 * system's jpeglib.h (the 6.2 ABI Pillow's library exports) and linked to Pillow's library.
 *
 * fjw_compress: pixels -> a JPEG with each component's sampling factors, a scan script (or
 * jpeg_simple_progression), arithmetic coding with chosen DAC conditioning, restart
 * intervals in MCUs or MCU rows, optimised Huffman tables.
 * fjw_transcode: a JPEG's coefficients (optionally replaced, and their tables) -> a JPEG
 * written with those settings (jpeg_read_coefficients, jpeg_write_coefficients).
 *
 * Each returns 0, or 1 with libjpeg's message in err; the file is in *out (free with
 * fjw_free). */

#include <setjmp.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

typedef struct {
  struct jpeg_error_mgr pub;
  jmp_buf jump;
  char *err;
  int err_len;
} error_mgr;

static void on_error(j_common_ptr cinfo) {
  error_mgr *e = (error_mgr *)cinfo->err;
  char msg[JMSG_LENGTH_MAX];
  (*cinfo->err->format_message)(cinfo, msg);
  snprintf(e->err, (size_t)e->err_len, "%s", msg);
  longjmp(e->jump, 1);
}

static void quiet(j_common_ptr cinfo) { (void)cinfo; }

/* the settings both writers share; scans: n_scans rows of (n, c0, c1, c2, c3, ss, se, ah,
 * al); n_scans 0: the default script (one interleaved scan, or jpeg_simple_progression when
 * progressive); dac: L[16], U[16], K[16] or NULL for the defaults */
static void settings(j_compress_ptr c, const int *scans, int n_scans, int progressive,
                     int arith, int restart_interval, int restart_rows, int optimize,
                     const int *dac) {
  if (n_scans > 0) {
    jpeg_scan_info *info = (jpeg_scan_info *)(*c->mem->alloc_small)(
        (j_common_ptr)c, JPOOL_IMAGE, sizeof(jpeg_scan_info) * (size_t)n_scans);
    for (int s = 0; s < n_scans; ++s) {
      const int *r = scans + 9 * s;
      info[s].comps_in_scan = r[0];
      for (int i = 0; i < 4; ++i) info[s].component_index[i] = r[1 + i];
      info[s].Ss = r[5];
      info[s].Se = r[6];
      info[s].Ah = r[7];
      info[s].Al = r[8];
    }
    c->scan_info = info;
    c->num_scans = n_scans;
  } else if (progressive) {
    jpeg_simple_progression(c);
  }
  c->arith_code = arith ? TRUE : FALSE;
  c->optimize_coding = optimize ? TRUE : FALSE;
  c->restart_interval = (unsigned int)restart_interval;
  c->restart_in_rows = restart_rows;
  if (dac) {
    for (int i = 0; i < 16; ++i) {
      c->arith_dc_L[i] = (UINT8)dac[i];
      c->arith_dc_U[i] = (UINT8)dac[16 + i];
      c->arith_ac_K[i] = (UINT8)dac[32 + i];
    }
  }
}

void fjw_free(unsigned char *p) { free(p); }

/* pixels [height][width][in_components] in in_space (J_COLOR_SPACE) -> a JPEG in
 * jpeg_space, component i sampled h[i] x v[i], quality 1-100 */
int fjw_compress(const unsigned char *pixels, int width, int height, int in_components,
                 int in_space, int jpeg_space, const int *h, const int *v, int quality,
                 const int *scans, int n_scans, int progressive, int arith,
                 int restart_interval, int restart_rows, int optimize, const int *dac,
                 unsigned char **out, unsigned long *out_size, char *err, int err_len) {
  struct jpeg_compress_struct c;
  error_mgr e;
  c.err = jpeg_std_error(&e.pub);
  e.pub.error_exit = on_error;
  e.pub.output_message = quiet;
  e.err = err;
  e.err_len = err_len;
  *out = NULL;
  *out_size = 0;
  if (setjmp(e.jump)) {
    jpeg_destroy_compress(&c);
    free(*out);
    *out = NULL;
    return 1;
  }
  jpeg_create_compress(&c);
  jpeg_mem_dest(&c, out, out_size);
  c.image_width = (JDIMENSION)width;
  c.image_height = (JDIMENSION)height;
  c.input_components = in_components;
  c.in_color_space = (J_COLOR_SPACE)in_space;
  jpeg_set_defaults(&c);
  jpeg_set_colorspace(&c, (J_COLOR_SPACE)jpeg_space);
  jpeg_set_quality(&c, quality, TRUE);
  for (int i = 0; i < c.num_components; ++i) {
    c.comp_info[i].h_samp_factor = h[i];
    c.comp_info[i].v_samp_factor = v[i];
  }
  settings(&c, scans, n_scans, progressive, arith, restart_interval, restart_rows, optimize,
           dac);
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = (JSAMPROW)(pixels + (size_t)c.next_scanline * width * in_components);
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  return 0;
}

/* A JPEG's coefficients, rewritten with the settings above. coefs, where not NULL, holds for
 * each component NULL or its blocks [rows][cols][64] (natural order, the decoder's block
 * arrays: the component's blocks rounded up to whole MCUs), written in place of the file's;
 * quant, where not NULL, 4 x 64 values (natural order, 0: keep the file's) for its tables. */
int fjw_transcode(const unsigned char *data, unsigned long size, const int *scans,
                  int n_scans, int progressive, int arith, int restart_interval,
                  int restart_rows, int optimize, const int *dac, short *const *coefs,
                  const int *quant, unsigned char **out, unsigned long *out_size, char *err,
                  int err_len) {
  struct jpeg_decompress_struct d;
  struct jpeg_compress_struct c;
  error_mgr e;
  d.err = jpeg_std_error(&e.pub);
  c.err = d.err;
  e.pub.error_exit = on_error;
  e.pub.output_message = quiet;
  e.err = err;
  e.err_len = err_len;
  *out = NULL;
  *out_size = 0;
  int made = 0;
  if (setjmp(e.jump)) {
    if (made) jpeg_destroy_compress(&c);
    jpeg_destroy_decompress(&d);
    free(*out);
    *out = NULL;
    return 1;
  }
  jpeg_create_decompress(&d);
  jpeg_mem_src(&d, data, size);
  jpeg_read_header(&d, TRUE);
  jvirt_barray_ptr *arrays = jpeg_read_coefficients(&d);
  jpeg_create_compress(&c);
  made = 1;
  jpeg_mem_dest(&c, out, out_size);
  jpeg_copy_critical_parameters(&d, &c);
  if (quant) {
    for (int t = 0; t < 4; ++t) {
      if (!c.quant_tbl_ptrs[t] || !quant[64 * t]) continue;
      for (int k = 0; k < 64; ++k) c.quant_tbl_ptrs[t]->quantval[k] = (UINT16)quant[64 * t + k];
    }
  }
  settings(&c, scans, n_scans, progressive, arith, restart_interval, restart_rows, optimize,
           dac);
  if (coefs) {
    for (int ci = 0; ci < d.num_components; ++ci) {
      if (!coefs[ci]) continue;
      jpeg_component_info *comp = d.comp_info + ci;
      JDIMENSION cols = (comp->width_in_blocks + comp->h_samp_factor - 1) /
                        comp->h_samp_factor * comp->h_samp_factor;
      JDIMENSION rows = (comp->height_in_blocks + comp->v_samp_factor - 1) /
                        comp->v_samp_factor * comp->v_samp_factor;
      for (JDIMENSION r = 0; r < rows; ++r) {
        JBLOCKARRAY row = (*d.mem->access_virt_barray)((j_common_ptr)&d, arrays[ci], r, 1, TRUE);
        memcpy(row[0], coefs[ci] + (size_t)r * cols * 64, sizeof(JBLOCK) * cols);
      }
    }
  }
  jpeg_write_coefficients(&c, arrays);
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  jpeg_finish_decompress(&d);
  jpeg_destroy_decompress(&d);
  return 0;
}
