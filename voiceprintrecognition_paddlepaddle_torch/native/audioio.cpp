// Native audio I/O hot path for the data loader.
//
// The reference leans on libsndfile + resampy through yeaudio for decode /
// resample (SURVEY.md §2, reference requirements.txt). This library is the
// C++ equivalent for the host side of the TPU pipeline: RIFF/WAVE decode
// (PCM 8/16/24/32, IEEE float32/64, any channel count -> mono float32),
// a windowed-sinc polyphase resampler, and RMS — the per-sample work
// the CPU does while the TPU runs the jitted step. Exposed as a C ABI for
// ctypes (no pybind11 in this image).
//
// Build flags live in audio_native._build() and the Makefile (kept
// identical so both artifacts behave the same).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <atomic>
#include <fstream>
#include <thread>
#include <vector>

// ---------------------------------------------------------------------
// polyphase windowed-sinc resampler (Kaiser window) — internal core
// ---------------------------------------------------------------------
static double bessel_i0(double x) {
    // series expansion, converges fast for the beta range used here
    double sum = 1.0, term = 1.0;
    const double x2 = x * x / 4.0;
    for (int k = 1; k < 64; ++k) {
        term *= x2 / (k * (double)k);
        sum += term;
        if (term < 1e-16 * sum) break;
    }
    return sum;
}

static int64_t gcd64(int64_t a, int64_t b) {
    while (b) { int64_t t = a % b; a = b; b = t; }
    return a;
}

// Kaiser-windowed sinc bank for a gcd-reduced up/down ratio: up phases of
// 2*half_taps taps, each phase normalised to sum 1 (unity passband gain).
// Output sample j sits at input time T = j*down/up = i_center + phase/up:
//   y[j] = sum_t  f(phase/up + half-1-t) * in[i_center - half+1 + t]
// with f cut off at the narrower Nyquist.
static void design_kaiser(int64_t up, int64_t down, int half_taps,
                          std::vector<float>& filt) {
    const double cutoff = 0.5 * std::min<double>(1.0, (double)up / down);
    const double beta = 8.6;  // ~ resampy/scipy "kaiser_best" quality class
    const int64_t taps_per_phase = 2 * half_taps;
    filt.resize((size_t)(up * taps_per_phase));
    const double i0b = bessel_i0(beta);
    for (int64_t p = 0; p < up; ++p) {
        double sum = 0.0;
        for (int64_t t = 0; t < taps_per_phase; ++t) {
            const double x = (double)p / up + (half_taps - 1 - t);
            const double sinc = (x == 0.0)
                ? 2.0 * cutoff
                : std::sin(2.0 * M_PI * cutoff * x) / (M_PI * x);
            const double w_arg = x / half_taps;
            double w = 0.0;
            if (std::fabs(w_arg) <= 1.0)
                w = bessel_i0(beta * std::sqrt(1.0 - w_arg * w_arg)) / i0b;
            filt[(size_t)(p * taps_per_phase + t)] = (float)(sinc * w);
            sum += sinc * w;
        }
        if (sum != 0.0) {
            const float inv = (float)(1.0 / sum);
            for (int64_t t = 0; t < taps_per_phase; ++t)
                filt[(size_t)(p * taps_per_phase + t)] *= inv;
        }
    }
}

// Polyphase convolution against a pre-designed bank (gcd-reduced ratio);
// interior samples skip the bounds check so -O3 can vectorise the tap loop.
static void convolve_polyphase(const float* in, int64_t n, int64_t up,
                               int64_t down, int half_taps,
                               const std::vector<float>& filt,
                               std::vector<float>& res) {
    const int64_t taps_per_phase = 2 * half_taps;
    const int64_t m = (n * up) / down;
    res.resize((size_t)(m > 0 ? m : 0));
    for (int64_t j = 0; j < m; ++j) {
        const int64_t num = j * down;
        const int64_t i_center = num / up;
        const int64_t phase = num % up;
        const float* h = &filt[(size_t)(phase * taps_per_phase)];
        const int64_t base = i_center - half_taps + 1;
        float acc = 0.0f;
        if (base >= 0 && base + taps_per_phase <= n) {
            const float* s = in + base;
            for (int64_t t = 0; t < taps_per_phase; ++t) acc += h[t] * s[t];
        } else {
            for (int64_t t = 0; t < taps_per_phase; ++t) {
                const int64_t idx = base + t;
                if (idx >= 0 && idx < n) acc += h[t] * in[idx];
            }
        }
        res[(size_t)j] = acc;
    }
}

static void resample_core(const float* in, int64_t n, int64_t up,
                          int64_t down, int half_taps,
                          std::vector<float>& res) {
    const int64_t g0 = gcd64(up, down);
    up /= g0;
    down /= g0;
    std::vector<float> filt;
    design_kaiser(up, down, half_taps, filt);
    convolve_polyphase(in, n, up, down, half_taps, filt, res);
}

extern "C" {

// ---------------------------------------------------------------------
// memory management: buffers returned to Python are freed with vpr_free
// ---------------------------------------------------------------------
void vpr_free(void* p) { std::free(p); }

// ---------------------------------------------------------------------
// WAV decode
// ---------------------------------------------------------------------
static inline uint32_t rd_u32(const uint8_t* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
}
static inline uint16_t rd_u16(const uint8_t* p) {
    return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

// Returns 0 on success. *out is malloc'd mono float32 of *n_samples.
int vpr_decode_wav(const uint8_t* data, int64_t size, float** out,
                   int64_t* n_samples, int32_t* sample_rate) {
    *out = nullptr;
    *n_samples = 0;
    *sample_rate = 0;
    if (size < 44 || std::memcmp(data, "RIFF", 4) != 0 ||
        std::memcmp(data + 8, "WAVE", 4) != 0)
        return 1;

    uint16_t fmt_code = 0, channels = 0, bits = 0;
    uint32_t rate = 0;
    const uint8_t* body = nullptr;
    uint32_t body_size = 0;

    int64_t pos = 12;
    while (pos + 8 <= size) {
        const uint8_t* cid = data + pos;
        uint32_t csize = rd_u32(data + pos + 4);
        const uint8_t* cbody = data + pos + 8;
        if ((int64_t)(pos + 8 + (int64_t)csize) > size)
            csize = (uint32_t)(size - pos - 8);
        if (std::memcmp(cid, "fmt ", 4) == 0 && csize >= 16) {
            fmt_code = rd_u16(cbody);
            channels = rd_u16(cbody + 2);
            rate = rd_u32(cbody + 4);
            bits = rd_u16(cbody + 14);
            if (fmt_code == 0xFFFE && csize >= 40)  // WAVE_FORMAT_EXTENSIBLE
                fmt_code = rd_u16(cbody + 24);
        } else if (std::memcmp(cid, "data", 4) == 0) {
            body = cbody;
            body_size = csize;
        }
        // int64 advance: a bogus csize near UINT32_MAX must not wrap the
        // 32-bit sum and crawl the file 8 bytes at a time
        pos += 8 + (int64_t)csize + (int64_t)(csize & 1);
    }
    if (!body || channels == 0 || rate == 0) return 2;

    int64_t frames;
    const double inv_ch = 1.0 / channels;
    float* mono = nullptr;

    if (fmt_code == 1 && bits == 16) {
        frames = body_size / (2 * channels);
        mono = (float*)std::malloc(sizeof(float) * frames);
        if (!mono) return 4;
        const int16_t* s = (const int16_t*)body;
        for (int64_t i = 0; i < frames; ++i) {
            double acc = 0;
            for (int c = 0; c < channels; ++c) acc += s[i * channels + c];
            mono[i] = (float)(acc * inv_ch / 32768.0);
        }
    } else if (fmt_code == 1 && bits == 32) {
        frames = body_size / (4 * channels);
        mono = (float*)std::malloc(sizeof(float) * frames);
        if (!mono) return 4;
        const int32_t* s = (const int32_t*)body;
        for (int64_t i = 0; i < frames; ++i) {
            double acc = 0;
            for (int c = 0; c < channels; ++c) acc += s[i * channels + c];
            mono[i] = (float)(acc * inv_ch / 2147483648.0);
        }
    } else if (fmt_code == 1 && bits == 24) {
        frames = body_size / (3 * channels);
        mono = (float*)std::malloc(sizeof(float) * frames);
        if (!mono) return 4;
        for (int64_t i = 0; i < frames; ++i) {
            double acc = 0;
            for (int c = 0; c < channels; ++c) {
                const uint8_t* b = body + 3 * (i * channels + c);
                int32_t v = (int32_t)b[0] | ((int32_t)b[1] << 8) |
                            ((int32_t)b[2] << 16);
                if (v >= (1 << 23)) v -= (1 << 24);
                acc += v;
            }
            mono[i] = (float)(acc * inv_ch / 8388608.0);
        }
    } else if (fmt_code == 1 && bits == 8) {
        frames = body_size / channels;
        mono = (float*)std::malloc(sizeof(float) * frames);
        if (!mono) return 4;
        for (int64_t i = 0; i < frames; ++i) {
            double acc = 0;
            for (int c = 0; c < channels; ++c)
                acc += (double)body[i * channels + c] - 128.0;
            mono[i] = (float)(acc * inv_ch / 128.0);
        }
    } else if (fmt_code == 3 && bits == 32) {
        frames = body_size / (4 * channels);
        mono = (float*)std::malloc(sizeof(float) * frames);
        if (!mono) return 4;
        const float* s = (const float*)body;
        for (int64_t i = 0; i < frames; ++i) {
            double acc = 0;
            for (int c = 0; c < channels; ++c) acc += s[i * channels + c];
            mono[i] = (float)(acc * inv_ch);
        }
    } else if (fmt_code == 3 && bits == 64) {
        frames = body_size / (8 * channels);
        mono = (float*)std::malloc(sizeof(float) * frames);
        if (!mono) return 4;
        const double* s = (const double*)body;
        for (int64_t i = 0; i < frames; ++i) {
            double acc = 0;
            for (int c = 0; c < channels; ++c) acc += s[i * channels + c];
            mono[i] = (float)(acc * inv_ch);
        }
    } else {
        return 3;  // unsupported encoding
    }

    *out = mono;
    *n_samples = frames;
    *sample_rate = (int32_t)rate;
    return 0;
}

// Resample n samples from sr_in to sr_out. *out malloc'd, length *n_out.
int vpr_resample(const float* in, int64_t n, int32_t sr_in, int32_t sr_out,
                 float** out, int64_t* n_out) {
    *out = nullptr;
    *n_out = 0;
    if (n <= 0 || sr_in <= 0 || sr_out <= 0) return 1;
    if (sr_in == sr_out) {
        *out = (float*)std::malloc(sizeof(float) * n);
        if (!*out) return 4;
        std::memcpy(*out, in, sizeof(float) * n);
        *n_out = n;
        return 0;
    }
    std::vector<float> res;
    try {
        resample_core(in, n, sr_out, sr_in, 16, res);
    } catch (...) {
        return 4;
    }
    const int64_t m = (int64_t)res.size();
    float* buf = (float*)std::malloc(sizeof(float) * (m > 0 ? m : 1));
    if (!buf) return 4;
    if (m > 0) std::memcpy(buf, res.data(), sizeof(float) * m);
    *out = buf;
    *n_out = m;
    return 0;
}

// ---------------------------------------------------------------------
// batched train loader: read + decode + (sr & speed) resample + crop +
// int16 quantize for a whole batch inside a C++ thread pool — the
// GIL-free equivalent of the reference's multiprocess DataLoader workers
// (reference ppvector/trainer.py:108-111). One call per batch; failures
// are signalled per item (valid[i] < 0) for a Python fallback.
// ---------------------------------------------------------------------

// speed[i] as a num/den fraction (0.9 = 9/10, 1.0 = 1/1, 1.1 = 11/10);
// crop_frac in [0, 1) picks the crop window start. Output row i: int16
// samples cropped/zero-padded to target_len; valid[i] = valid samples,
// -1 = unreadable file; duration_s[i] = decoded duration (for
// min-duration policy in Python).
int vpr_load_batch(const char* const* paths, int32_t n_items,
                   int32_t target_sr, int64_t target_len,
                   const int32_t* speed_num, const int32_t* speed_den,
                   const float* crop_frac, int16_t* out, int64_t* valid,
                   double* duration_s, int32_t n_threads) {
    std::atomic<int32_t> next{0};
    auto work = [&]() {
        std::vector<uint8_t> buf;
        std::vector<float> res;
        // per-thread filter cache: a batch sees at most a few distinct
        // (up, down) ratios (speed 0.9/1.0/1.1 x source rates), and a
        // bank costs ~tens of thousands of bessel_i0 evaluations
        struct Bank { int64_t up, down; std::vector<float> filt; };
        std::vector<Bank> banks;
        for (;;) {
            const int32_t i = next.fetch_add(1);
            if (i >= n_items) return;
            valid[i] = -1;
            duration_s[i] = 0.0;
            int16_t* dst = out + (int64_t)i * target_len;
            std::memset(dst, 0, sizeof(int16_t) * target_len);

            float* dec = nullptr;
            // any failure (I/O, allocation, corrupt size fields) must
            // mark the item for the Python per-item fallback — an
            // uncaught exception in a std::thread is std::terminate
            try {
                std::ifstream f(paths[i],
                                std::ios::binary | std::ios::ate);
                if (!f) continue;
                const std::streamsize sz = f.tellg();
                if (sz <= 0) continue;
                buf.resize((size_t)sz);
                f.seekg(0);
                if (!f.read((char*)buf.data(), sz)) continue;

                int64_t nd = 0;
                int32_t sr = 0;
                if (vpr_decode_wav(buf.data(), sz, &dec, &nd, &sr) != 0 ||
                    nd <= 0 || sr <= 0) {
                    if (dec) { std::free(dec); dec = nullptr; }
                    continue;
                }
                duration_s[i] = (double)nd / sr;

                int64_t up = (int64_t)target_sr * speed_den[i];
                int64_t down = (int64_t)sr * speed_num[i];
                const float* src = dec;
                int64_t ns = nd;
                if (up != down) {
                    const int64_t g0 = gcd64(up, down);
                    up /= g0;
                    down /= g0;
                    Bank* bank = nullptr;
                    for (auto& b : banks)
                        if (b.up == up && b.down == down) { bank = &b; break; }
                    if (!bank) {
                        banks.push_back({up, down, {}});
                        bank = &banks.back();
                        design_kaiser(up, down, 16, bank->filt);
                    }
                    convolve_polyphase(dec, nd, up, down, 16, bank->filt,
                                       res);
                    src = res.data();
                    ns = (int64_t)res.size();
                }

                int64_t start = 0;
                if (ns > target_len) {
                    start = (int64_t)((double)crop_frac[i]
                                      * (double)(ns - target_len + 1));
                    if (start > ns - target_len) start = ns - target_len;
                    if (start < 0) start = 0;
                }
                const int64_t v = std::min<int64_t>(ns, target_len);
                for (int64_t t = 0; t < v; ++t) {
                    float x = src[start + t];
                    x = x < -1.0f ? -1.0f : (x > 1.0f ? 1.0f : x);
                    dst[t] = (int16_t)(x * 32767.0f);  // trunc matches numpy
                }
                valid[i] = v;
            } catch (...) {
                valid[i] = -1;
            }
            if (dec) std::free(dec);
        }
    };
    if (n_threads < 1) n_threads = 1;
    if (n_threads > n_items) n_threads = n_items;
    std::vector<std::thread> pool;
    for (int32_t t = 1; t < n_threads; ++t) pool.emplace_back(work);
    work();
    for (auto& th : pool) th.join();
    return 0;
}

// ---------------------------------------------------------------------
// RMS utility for dB-normalisation on the host path
// ---------------------------------------------------------------------
double vpr_rms_db(const float* in, int64_t n) {
    if (n <= 0) return -100.0;
    double acc = 0.0;
    for (int64_t i = 0; i < n; ++i) acc += (double)in[i] * in[i];
    const double mean_sq = acc / n;
    if (mean_sq <= 1e-30) return -100.0;
    return 10.0 * std::log10(mean_sq);
}

}  // extern "C"
