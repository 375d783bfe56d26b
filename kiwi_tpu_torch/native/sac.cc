// SAC binary waveform codec (C++), the native twin of kiwi_tpu_torch/io/sac.py.
//
// Replaces the reference's libsacio link (dummy_sacio/sacio.c aborts; real
// deployments link Fortran libsacio; seismogram_io.f90:97-128 uses only the
// wsac1/rsac1 subset).  Layout: 70 f32 header words, 40 i32 words, 192
// bytes of strings, then f32 samples; byte order auto-detected on read via
// the nvhdr word.  Byte-identical to the Python codec (tests compare).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr float kUndefF = -12345.0f;
constexpr int32_t kUndefI = -12345;
constexpr int32_t kNvhdr = 6;
constexpr int32_t kItime = 1;
constexpr size_t kHdrBytes = 70 * 4 + 40 * 4 + 192;

uint32_t bswap32(uint32_t v) {
  return ((v & 0xff) << 24) | ((v & 0xff00) << 8) | ((v >> 8) & 0xff00) |
         ((v >> 24) & 0xff);
}

float swapf(float x, bool sw) {
  if (!sw) return x;
  uint32_t u;
  std::memcpy(&u, &x, 4);
  u = bswap32(u);
  std::memcpy(&x, &u, 4);
  return x;
}

int32_t swapi(int32_t x, bool sw) {
  if (!sw) return x;
  uint32_t u;
  std::memcpy(&u, &x, 4);
  u = bswap32(u);
  std::memcpy(&x, &u, 4);
  return x;
}

}  // namespace

extern "C" {

// Write little-endian SAC (matching io/sac.py's default).  Returns 0 on ok.
int kiwi_sac_write(const char* filename, const float* data, int nsamples,
                   double toffset, double deltat, const char* station,
                   const char* channel) {
  std::FILE* f = std::fopen(filename, "wb");
  if (!f) return -1;

  float fh[70];
  int32_t ih[40];
  for (int i = 0; i < 70; i++) fh[i] = kUndefF;
  for (int i = 0; i < 40; i++) ih[i] = kUndefI;
  float mn = 0.0f, mx = 0.0f;
  if (nsamples > 0) {
    mn = mx = data[0];
    for (int i = 1; i < nsamples; i++) {
      if (data[i] < mn) mn = data[i];
      if (data[i] > mx) mx = data[i];
    }
  }
  fh[0] = static_cast<float>(deltat);
  fh[1] = mn;
  fh[2] = mx;
  fh[5] = static_cast<float>(toffset);
  fh[6] = static_cast<float>(toffset + deltat * (nsamples - 1));
  ih[6] = kNvhdr;
  ih[9] = nsamples;
  ih[15] = kItime;
  ih[35] = 1;  // leven

  char strings[192];
  std::memset(strings, ' ', sizeof strings);
  std::snprintf(strings, 9, "%-8.8s", station && *station ? station : "        ");
  strings[8] = ' ';  // snprintf wrote a NUL
  std::snprintf(strings + 160, 9, "%-8.8s",
                channel && *channel ? channel : "        ");
  strings[168] = ' ';

  bool ok = std::fwrite(fh, 4, 70, f) == 70 &&
            std::fwrite(ih, 4, 40, f) == 40 &&
            std::fwrite(strings, 1, 192, f) == 192 &&
            (nsamples == 0 ||
             std::fwrite(data, 4, nsamples, f) == static_cast<size_t>(nsamples));
  std::fclose(f);
  return ok ? 0 : -2;
}

// Sample count (for the caller to size its buffer); < 0 on error.
int kiwi_sac_nsamples(const char* filename) {
  std::FILE* f = std::fopen(filename, "rb");
  if (!f) return -1;
  unsigned char hdr[kHdrBytes];
  size_t got = std::fread(hdr, 1, kHdrBytes, f);
  std::fclose(f);
  if (got != kHdrBytes) return -2;
  int32_t nvhdr;
  std::memcpy(&nvhdr, hdr + 70 * 4 + 6 * 4, 4);
  bool sw = !(nvhdr >= 1 && nvhdr <= 10);
  if (sw) {
    nvhdr = swapi(nvhdr, true);
    if (!(nvhdr >= 1 && nvhdr <= 10)) return -3;
  }
  int32_t npts;
  std::memcpy(&npts, hdr + 70 * 4 + 9 * 4, 4);
  return swapi(npts, sw);
}

// Read into caller buffer of capacity nmax; returns sample count or < 0.
int kiwi_sac_read(const char* filename, float* out, int nmax, double* toffset,
                  double* deltat) {
  std::FILE* f = std::fopen(filename, "rb");
  if (!f) return -1;
  unsigned char hdr[kHdrBytes];
  if (std::fread(hdr, 1, kHdrBytes, f) != kHdrBytes) {
    std::fclose(f);
    return -2;
  }
  int32_t nvhdr;
  std::memcpy(&nvhdr, hdr + 70 * 4 + 6 * 4, 4);
  bool sw = !(nvhdr >= 1 && nvhdr <= 10);
  if (sw && !(swapi(nvhdr, true) >= 1 && swapi(nvhdr, true) <= 10)) {
    std::fclose(f);
    return -3;
  }
  int32_t npts;
  float delta, b;
  std::memcpy(&npts, hdr + 70 * 4 + 9 * 4, 4);
  std::memcpy(&delta, hdr + 0, 4);
  std::memcpy(&b, hdr + 5 * 4, 4);
  npts = swapi(npts, sw);
  *deltat = swapf(delta, sw);
  *toffset = swapf(b, sw);
  if (npts < 0 || npts > nmax) {
    std::fclose(f);
    return -4;
  }
  size_t got = std::fread(out, 4, npts, f);
  std::fclose(f);
  if (got != static_cast<size_t>(npts)) return -5;
  if (sw) {
    for (int i = 0; i < npts; i++) out[i] = swapf(out[i], true);
  }
  return npts;
}

}  // extern "C"
