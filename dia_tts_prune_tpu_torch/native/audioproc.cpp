// Native host-side audio processing for the dataset / serving pipelines,
// the PyTorch port's own copy of dia_tts_prune_tpu/native/audioproc.cpp.
//
// The reference leans on torchaudio/libsox native code for audio I/O and
// resampling (dia/model.py:546-576, finetune.py:95-111).  This library is the
// equivalent host-side native component: PCM conversion and windowed-sinc
// polyphase resampling, exposed through a C ABI consumed via ctypes.  The
// port's utils/audio_io.py writes the same 16-bit codes as f32_to_pcm16 in
// numpy, so that writing a WAV needs no compiler.
//
// Built by native/__init__.py on first use (g++ -O3 -shared -fPIC).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// int16 little-endian PCM -> float32 in [-1, 1)
void pcm16_to_f32(const int16_t* in, float* out, int64_t n) {
    constexpr float kScale = 1.0f / 32768.0f;
    for (int64_t i = 0; i < n; ++i) out[i] = static_cast<float>(in[i]) * kScale;
}

// float32 -> int16 PCM with round-to-nearest and clipping
void f32_to_pcm16(const float* in, int16_t* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        float v = in[i];
        if (v > 1.0f) v = 1.0f;
        if (v < -1.0f) v = -1.0f;
        float scaled = v * 32767.0f;
        out[i] = static_cast<int16_t>(scaled >= 0.0f ? scaled + 0.5f : scaled - 0.5f);
    }
}

// 24-bit little-endian packed PCM -> float32
void pcm24_to_f32(const uint8_t* in, float* out, int64_t n_samples) {
    constexpr float kScale = 1.0f / 8388608.0f;  // 2^23
    for (int64_t i = 0; i < n_samples; ++i) {
        const uint8_t* p = in + 3 * i;
        int32_t v = static_cast<int32_t>(p[0]) | (static_cast<int32_t>(p[1]) << 8) |
                    (static_cast<int32_t>(p[2]) << 16);
        if (v & 0x800000) v -= 0x1000000;  // sign extend
        out[i] = static_cast<float>(v) * kScale;
    }
}

// Multi-channel interleaved -> mono mean downmix
void downmix_mean(const float* in, float* out, int64_t frames, int channels) {
    const float inv = 1.0f / static_cast<float>(channels);
    for (int64_t t = 0; t < frames; ++t) {
        float acc = 0.0f;
        const float* row = in + t * channels;
        for (int c = 0; c < channels; ++c) acc += row[c];
        out[t] = acc * inv;
    }
}

namespace {
inline double sinc(double x) {
    if (x == 0.0) return 1.0;
    const double px = M_PI * x;
    return std::sin(px) / px;
}
}  // namespace

// Windowed-sinc polyphase resampler: in_rate -> out_rate, Kaiser-ish Hann
// window, `zeros` zero-crossings per side.  Returns the number of output
// samples written (caller sizes `out` as ceil(n_in * out_rate / in_rate)).
int64_t resample_sinc(const float* in, int64_t n_in, float* out, int64_t n_out_cap,
                      int in_rate, int out_rate, int zeros) {
    if (in_rate == out_rate) {
        int64_t n = n_in < n_out_cap ? n_in : n_out_cap;
        std::memcpy(out, in, sizeof(float) * static_cast<size_t>(n));
        return n;
    }
    const double ratio = static_cast<double>(out_rate) / in_rate;
    const double cutoff = ratio < 1.0 ? ratio : 1.0;  // anti-alias for downsample
    const double half_width = zeros / cutoff;
    const int64_t n_out = static_cast<int64_t>(std::floor(n_in * ratio));
    const int64_t limit = n_out < n_out_cap ? n_out : n_out_cap;

    for (int64_t j = 0; j < limit; ++j) {
        const double t_in = j / ratio;  // position in input samples
        const int64_t lo = static_cast<int64_t>(std::ceil(t_in - half_width));
        const int64_t hi = static_cast<int64_t>(std::floor(t_in + half_width));
        double acc = 0.0, wsum = 0.0;
        for (int64_t i = (lo < 0 ? 0 : lo); i <= hi && i < n_in; ++i) {
            const double d = (t_in - i) * cutoff;
            // Hann window over the sinc support
            const double wpos = (t_in - i) / half_width;  // in [-1, 1]
            const double win = 0.5 * (1.0 + std::cos(M_PI * wpos));
            const double w = sinc(d) * win;
            acc += w * in[i];
            wsum += w;
        }
        out[j] = wsum != 0.0 ? static_cast<float>(acc * cutoff)
                             : 0.0f;
    }
    return limit;
}

// Peak and RMS metering (serving diagnostics)
void audio_stats(const float* in, int64_t n, float* peak_out, float* rms_out) {
    double peak = 0.0, sq = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        const double a = std::fabs(in[i]);
        if (a > peak) peak = a;
        sq += static_cast<double>(in[i]) * in[i];
    }
    *peak_out = static_cast<float>(peak);
    *rms_out = n > 0 ? static_cast<float>(std::sqrt(sq / n)) : 0.0f;
}

}  // extern "C"
