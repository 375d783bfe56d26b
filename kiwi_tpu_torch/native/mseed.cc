// Mini-SEED record codec (native replacement for the reference's libmseed
// shim, mseed/mseed_simple.c).
//
// Writes 4096-byte big-endian records with FLOAT32 encoding and a blockette
// 1000, and reads FLOAT32/FLOAT64/INT32/INT16/STEIM1/STEIM2 encoded records.
// Byte-compatible with the pure-Python codec in kiwi_tpu_torch/io/mseed.py (which
// is the format reference and fallback); this implementation exists for
// bulk-data throughput (large reference-seismogram datasets).
//
// C ABI for ctypes; no Python headers needed.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <ctime>
#include <vector>

namespace {

constexpr int RECLEN = 4096;
constexpr int DATA_OFFSET = 64;
constexpr int SAMPLES_PER_RECORD = (RECLEN - DATA_OFFSET) / 4;

inline void put_u16(uint8_t* p, uint16_t v) { p[0] = v >> 8; p[1] = v & 0xff; }
inline void put_i16(uint8_t* p, int16_t v) { put_u16(p, (uint16_t)v); }
inline void put_u32(uint8_t* p, uint32_t v) {
    p[0] = v >> 24; p[1] = (v >> 16) & 0xff; p[2] = (v >> 8) & 0xff; p[3] = v & 0xff;
}
inline uint16_t get_u16(const uint8_t* p) { return (uint16_t)((p[0] << 8) | p[1]); }
inline int16_t get_i16(const uint8_t* p) { return (int16_t)get_u16(p); }
inline uint32_t get_u32(const uint8_t* p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) | p[3];
}
inline int32_t get_i32(const uint8_t* p) { return (int32_t)get_u32(p); }

void put_f32(uint8_t* p, float v) {
    uint32_t u;
    std::memcpy(&u, &v, 4);
    put_u32(p, u);
}

float get_f32(const uint8_t* p) {
    uint32_t u = get_u32(p);
    float v;
    std::memcpy(&v, &u, 4);
    return v;
}

double get_f64(const uint8_t* p) {
    uint64_t u = ((uint64_t)get_u32(p) << 32) | get_u32(p + 4);
    double v;
    std::memcpy(&v, &u, 8);
    return v;
}

void encode_samprate(double rate, int16_t* fact, int16_t* mult) {
    double r = std::round(rate);
    if (std::fabs(rate - r) < 1e-7 * rate && r <= 32767.0) {
        *fact = (int16_t)r;
        *mult = 1;
        return;
    }
    double period = 1.0 / rate;
    double pr = std::round(period);
    if (std::fabs(period - pr) < 1e-7 * period && pr <= 32767.0) {
        *fact = (int16_t)(-pr);
        *mult = 1;
        return;
    }
    if (rate * 1000.0 <= 32767.0) {
        *fact = (int16_t)std::lround(rate * 1000.0);
        *mult = -1000;
    } else {
        *fact = (int16_t)std::lround(rate * 10.0);
        *mult = -10;
    }
}

double decode_samprate(int16_t fact, int16_t mult) {
    if (fact > 0 && mult > 0) return (double)fact * mult;
    if (fact > 0 && mult < 0) return -(double)fact / mult;
    if (fact < 0 && mult > 0) return -(double)mult / fact;
    if (fact < 0 && mult < 0) return 1.0 / ((double)fact * mult);
    return 0.0;
}

void pad_copy(char* dst, const char* src, int n) {
    int i = 0;
    for (; i < n && src && src[i]; i++) dst[i] = src[i];
    for (; i < n; i++) dst[i] = ' ';
}

// signed bit-field extraction for steim2
inline int32_t sx(uint32_t u, int shift, int bits) {
    uint32_t v = (u >> shift) & ((1u << bits) - 1u);
    if (v >= (1u << (bits - 1))) return (int32_t)v - (1 << bits);
    return (int32_t)v;
}

}  // namespace

extern "C" {

// Write float32 samples as Mini-SEED.  Returns 0 on success.
int kiwi_mseed_write(const char* filename, const float* data, int n,
                     double toffset, double deltat, const char* network,
                     const char* station, const char* location,
                     const char* channel) {
    FILE* f = std::fopen(filename, "wb");
    if (!f) return -1;

    int16_t fact, mult;
    encode_samprate(1.0 / deltat, &fact, &mult);

    int iseq = 1;
    int nrec = n > 0 ? (n + SAMPLES_PER_RECORD - 1) / SAMPLES_PER_RECORD : 1;
    for (int r = 0; r < nrec; r++) {
        int start = r * SAMPLES_PER_RECORD;
        int count = n - start;
        if (count > SAMPLES_PER_RECORD) count = SAMPLES_PER_RECORD;
        if (count < 0) count = 0;

        uint8_t rec[RECLEN];
        std::memset(rec, 0, RECLEN);

        char seq[8];
        std::snprintf(seq, sizeof seq, "%06d", iseq++);
        std::memcpy(rec, seq, 6);
        rec[6] = 'D';
        rec[7] = ' ';
        pad_copy((char*)rec + 8, station, 5);
        pad_copy((char*)rec + 13, location, 2);
        pad_copy((char*)rec + 15, channel, 3);
        pad_copy((char*)rec + 18, network, 2);

        // btime from epoch seconds, rounded to 1e-5 s like the reference
        // (mseed_simple.c:70-78)
        double t0 = toffset + (double)start * deltat;
        double t = std::round(t0 * 1e5) * 1e-5;
        double whole_d = std::floor(t);
        time_t whole = (time_t)whole_d;
        int frac = (int)std::lround((t - whole_d) * 1e4);
        if (frac >= 10000) {
            whole += 1;
            frac -= 10000;
        }
        struct tm tmv;
        gmtime_r(&whole, &tmv);
        put_u16(rec + 20, (uint16_t)(tmv.tm_year + 1900));
        put_u16(rec + 22, (uint16_t)(tmv.tm_yday + 1));
        rec[24] = (uint8_t)tmv.tm_hour;
        rec[25] = (uint8_t)tmv.tm_min;
        rec[26] = (uint8_t)tmv.tm_sec;
        rec[27] = 0;
        put_u16(rec + 28, (uint16_t)frac);
        put_u16(rec + 30, (uint16_t)count);
        put_i16(rec + 32, fact);
        put_i16(rec + 34, mult);
        rec[36] = rec[37] = rec[38] = 0;
        rec[39] = 1;  // one blockette
        put_u32(rec + 40, 0);  // time correction
        put_u16(rec + 44, DATA_OFFSET);
        put_u16(rec + 46, 48);

        // blockette 1000: FLOAT32, big endian, 2^12 record
        put_u16(rec + 48, 1000);
        put_u16(rec + 50, 0);
        rec[52] = 4;
        rec[53] = 1;
        rec[54] = 12;
        rec[55] = 0;

        for (int i = 0; i < count; i++)
            put_f32(rec + DATA_OFFSET + 4 * i, data[start + i]);

        if (std::fwrite(rec, RECLEN, 1, f) != 1) {
            std::fclose(f);
            return -2;
        }
    }
    std::fclose(f);
    return 0;
}

// First pass: total sample count (or < 0 on error).
// Second pass (data != nullptr): fill data, set toffset/deltat.
static int read_impl(const char* filename, float* data, int maxn,
                     double* toffset, double* deltat) {
    FILE* f = std::fopen(filename, "rb");
    if (!f) return -1;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::vector<uint8_t> blob((size_t)size);
    if (std::fread(blob.data(), 1, (size_t)size, f) != (size_t)size) {
        std::fclose(f);
        return -2;
    }
    std::fclose(f);

    long pos = 0;
    int64_t total = 0;
    bool first = true;
    while (pos + 64 <= size) {
        const uint8_t* h = blob.data() + pos;
        uint16_t nsamp = get_u16(h + 30);
        int16_t fact = get_i16(h + 32);
        int16_t mult = get_i16(h + 34);
        uint8_t nblk = h[39];
        uint16_t dofs = get_u16(h + 44);
        uint16_t bofs = get_u16(h + 46);

        int enc = 4;
        int reclen = RECLEN;
        uint16_t bo = bofs;
        for (int k = 0; k < nblk && bo != 0 && pos + bo + 8 <= size; k++) {
            uint16_t btype = get_u16(blob.data() + pos + bo);
            uint16_t bnext = get_u16(blob.data() + pos + bo + 2);
            if (btype == 1000) {
                enc = blob[pos + bo + 4];
                reclen = 1 << blob[pos + bo + 6];
                break;
            }
            bo = bnext;
        }
        if (pos + reclen > size) reclen = (int)(size - pos);

        if (first && toffset) {
            struct tm tmv;
            std::memset(&tmv, 0, sizeof tmv);
            tmv.tm_year = get_u16(h + 20) - 1900;
            tmv.tm_mday = 1;
            tmv.tm_mon = 0;
            time_t base = timegm(&tmv);
            int doy = get_u16(h + 22);
            double t = (double)base + (doy - 1) * 86400.0 + h[24] * 3600.0 +
                       h[25] * 60.0 + h[26] + get_u16(h + 28) * 1e-4;
            *toffset = t;
            *deltat = 1.0 / decode_samprate(fact, mult);
            first = false;
        }

        // A malformed dofs (0, < header size, or beyond the record) would put
        // the payload outside the record or even the file; treat such records
        // as carrying no samples, identically in the counting and the filling
        // pass so the caller's buffer stays consistent.
        if (dofs < 48 || (long)dofs >= (long)reclen) {
            pos += reclen > 0 ? reclen : 64;
            continue;
        }
        const uint8_t* payload = blob.data() + pos + dofs;
        long paylen = reclen - dofs;
        // Clamp the per-record sample count by what the payload can actually
        // hold, in BOTH passes (a truncated file or a header overstating nsamp
        // must not read past the blob).  STEIM is self-describing and already
        // bounded by paylen below; for it keep the header count but zero-fill
        // any undecoded tail.
        long navail = nsamp;
        if (enc == 4 || enc == 3) navail = paylen / 4;
        else if (enc == 5) navail = paylen / 8;
        else if (enc == 1) navail = paylen / 2;
        if (navail > nsamp) navail = nsamp;
        if (navail < 0) navail = 0;
        if (data) {
            float* out = data + total;
            int want = (int)navail;
            if (total + want > maxn) want = (int)(maxn - total);
            if (want < 0) want = 0;
            if (enc == 4) {
                for (int i = 0; i < want; i++) out[i] = get_f32(payload + 4 * i);
            } else if (enc == 5) {
                for (int i = 0; i < want; i++) out[i] = (float)get_f64(payload + 8 * i);
            } else if (enc == 3) {
                for (int i = 0; i < want; i++) out[i] = (float)get_i32(payload + 4 * i);
            } else if (enc == 1) {
                for (int i = 0; i < want; i++) out[i] = (float)get_i16(payload + 2 * i);
            } else if (enc == 10 || enc == 11) {
                std::memset(out, 0, (size_t)want * sizeof(float));
                // STEIM decode
                std::vector<int64_t> diffs;
                diffs.reserve(nsamp + 8);
                int32_t x0 = 0;
                bool have_x0 = false;
                int nframes = (int)(paylen / 64);
                for (int fi = 0; fi < nframes; fi++) {
                    const uint8_t* frame = payload + fi * 64;
                    uint32_t w0 = get_u32(frame);
                    for (int wi = 1; wi < 16; wi++) {
                        int c = (w0 >> (2 * (15 - wi))) & 0x3;
                        const uint8_t* word = frame + wi * 4;
                        if (fi == 0 && wi == 1) { x0 = get_i32(word); have_x0 = true; continue; }
                        if (fi == 0 && wi == 2) { continue; }  // xn
                        if (c == 0) continue;
                        if (enc == 10) {  // steim1
                            if (c == 1) {
                                for (int j = 0; j < 4; j++) diffs.push_back((int8_t)word[j]);
                            } else if (c == 2) {
                                diffs.push_back(get_i16(word));
                                diffs.push_back(get_i16(word + 2));
                            } else {
                                diffs.push_back(get_i32(word));
                            }
                        } else {  // steim2
                            if (c == 1) {
                                for (int j = 0; j < 4; j++) diffs.push_back((int8_t)word[j]);
                            } else {
                                uint32_t u = get_u32(word);
                                int dnib = (u >> 30) & 0x3;
                                if (c == 2) {
                                    if (dnib == 1) diffs.push_back(sx(u, 0, 30));
                                    else if (dnib == 2) { diffs.push_back(sx(u, 15, 15)); diffs.push_back(sx(u, 0, 15)); }
                                    else { diffs.push_back(sx(u, 20, 10)); diffs.push_back(sx(u, 10, 10)); diffs.push_back(sx(u, 0, 10)); }
                                } else {
                                    if (dnib == 0) for (int sh : {24, 18, 12, 6, 0}) diffs.push_back(sx(u, sh, 6));
                                    else if (dnib == 1) for (int sh : {25, 20, 15, 10, 5, 0}) diffs.push_back(sx(u, sh, 5));
                                    else for (int sh : {24, 20, 16, 12, 8, 4, 0}) diffs.push_back(sx(u, sh, 4));
                                }
                            }
                        }
                    }
                }
                if (have_x0) {
                    int64_t acc = 0;
                    for (int i = 0; i < want && i < (int)diffs.size(); i++) {
                        acc += diffs[i];
                        if (i == 0) acc = x0;
                        out[i] = (float)acc;
                    }
                }
            } else {
                return -3;  // unsupported encoding
            }
        }
        total += navail;
        if (total > 0x7fffffff) return -2;
        pos += reclen > 0 ? reclen : 64;
    }
    return (int)total;
}

int kiwi_mseed_nsamples(const char* filename) {
    return read_impl(filename, nullptr, 0, nullptr, nullptr);
}

int kiwi_mseed_read(const char* filename, float* data, int maxn,
                    double* toffset, double* deltat) {
    return read_impl(filename, data, maxn, toffset, deltat);
}

}  // extern "C"
