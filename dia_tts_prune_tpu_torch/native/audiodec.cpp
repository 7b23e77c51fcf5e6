// Compressed-audio decode via the system FFmpeg libraries (host-side), the
// PyTorch port's own copy of dia_tts_prune_tpu/native/audiodec.cpp.
//
// The torch reference loads voice prompts of any format through torchaudio,
// whose native backend is ffmpeg/libsox (reference dia/model.py:551-559).
// This shim is the equivalent: libavformat demux + libavcodec decode +
// libswresample to float32, exposed to Python via ctypes
// (native/__init__.py::decode_audio_file).  It handles mp3 (incl. the
// reference's bundled example_prompt.mp3), ogg, m4a/aac, opus, wma, ...
//
// The in-repo from-scratch decoders (utils/flac.py, native/mp3dec.cpp)
// remain the zero-dependency paths; this library is the catch-all and the
// test oracle for mp3dec (tests/test_torch_native.py).
//
// One difference from the JAX copy: adec_decode_file takes its buffer's
// capacity in floats and never copies past it, whatever channel count the
// second decode reports.
//
// Build: g++ -O2 -shared -fPIC -o libaudiodec.so audiodec.cpp
//        -lavformat -lavcodec -lavutil -lswresample

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct DecodeResult {
  std::vector<float> pcm;  // interleaved
  int sample_rate = 0;
  int channels = 0;
  int err = 0;
};

// Decode the file at `path` to interleaved float32 at its native rate.
// When target_sr > 0, resample to target_sr; when mono != 0, downmix.
DecodeResult decode(const char* path, int target_sr, int mono) {
  DecodeResult out;
  av_log_set_level(AV_LOG_ERROR);
  AVFormatContext* fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) {
    out.err = 1;
    return out;
  }
  if (avformat_find_stream_info(fmt, nullptr) < 0) {
    avformat_close_input(&fmt);
    out.err = 2;
    return out;
  }
  const AVCodec* codec = nullptr;
  int stream = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
  if (stream < 0 || !codec) {
    avformat_close_input(&fmt);
    out.err = 3;
    return out;
  }
  AVCodecContext* ctx = avcodec_alloc_context3(codec);
  avcodec_parameters_to_context(ctx, fmt->streams[stream]->codecpar);
  if (avcodec_open2(ctx, codec, nullptr) < 0) {
    avcodec_free_context(&ctx);
    avformat_close_input(&fmt);
    out.err = 4;
    return out;
  }

  int in_rate = ctx->sample_rate;
  int out_rate = target_sr > 0 ? target_sr : in_rate;
  AVChannelLayout in_layout;
  if (ctx->ch_layout.nb_channels > 0)
    av_channel_layout_copy(&in_layout, &ctx->ch_layout);
  else
    av_channel_layout_default(&in_layout, 1);
  AVChannelLayout out_layout;
  if (mono)
    av_channel_layout_default(&out_layout, 1);
  else
    av_channel_layout_copy(&out_layout, &in_layout);

  SwrContext* swr = nullptr;
  swr_alloc_set_opts2(&swr, &out_layout, AV_SAMPLE_FMT_FLT, out_rate,
                      &in_layout, ctx->sample_fmt, in_rate, 0, nullptr);
  if (!swr || swr_init(swr) < 0) {
    if (swr) swr_free(&swr);
    avcodec_free_context(&ctx);
    avformat_close_input(&fmt);
    out.err = 5;
    return out;
  }

  out.sample_rate = out_rate;
  out.channels = out_layout.nb_channels;

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  std::vector<float> buf;

  auto drain_swr = [&](const AVFrame* f) {
    int in_n = f ? f->nb_samples : 0;
    const uint8_t** in_data = f ? (const uint8_t**)f->extended_data : nullptr;
    int max_out = swr_get_out_samples(swr, in_n);
    if (max_out <= 0) max_out = in_n + 256;
    buf.resize((size_t)max_out * out.channels);
    uint8_t* out_ptr = (uint8_t*)buf.data();
    int got = swr_convert(swr, &out_ptr, max_out, in_data, in_n);
    if (got > 0)
      out.pcm.insert(out.pcm.end(), buf.begin(),
                     buf.begin() + (size_t)got * out.channels);
  };

  while (av_read_frame(fmt, pkt) >= 0) {
    if (pkt->stream_index == stream) {
      if (avcodec_send_packet(ctx, pkt) >= 0)
        while (avcodec_receive_frame(ctx, frame) >= 0) drain_swr(frame);
    }
    av_packet_unref(pkt);
  }
  // flush decoder then resampler
  avcodec_send_packet(ctx, nullptr);
  while (avcodec_receive_frame(ctx, frame) >= 0) drain_swr(frame);
  drain_swr(nullptr);

  av_frame_free(&frame);
  av_packet_free(&pkt);
  swr_free(&swr);
  avcodec_free_context(&ctx);
  avformat_close_input(&fmt);
  return out;
}

}  // namespace

extern "C" {

// Probe: returns total decoded samples per channel, or -err on failure.
// Decodes fully (audio files are small); callers then allocate and call
// adec_decode_file which re-decodes.  For the prompt-sized files this
// framework handles, simplicity beats a streaming API.
int64_t adec_probe(const char* path, int target_sr, int mono,
                   int* sample_rate, int* channels) {
  DecodeResult r = decode(path, target_sr, mono);
  if (r.err) return -r.err;
  *sample_rate = r.sample_rate;
  *channels = r.channels;
  return (int64_t)(r.pcm.size() / (r.channels > 0 ? r.channels : 1));
}

// Decode into a caller-allocated interleaved buffer of max_floats floats.
// Returns samples per channel written (at most max_floats / channels), or
// -err.
int64_t adec_decode_file(const char* path, int target_sr, int mono,
                         float* out, int64_t max_floats, int* sample_rate,
                         int* channels) {
  DecodeResult r = decode(path, target_sr, mono);
  if (r.err) return -r.err;
  *sample_rate = r.sample_rate;
  *channels = r.channels;
  int ch = r.channels > 0 ? r.channels : 1;
  int64_t n = (int64_t)(r.pcm.size() / ch);
  if (n > max_floats / ch) n = max_floats / ch;
  memcpy(out, r.pcm.data(), (size_t)n * ch * sizeof(float));
  return n;
}

// Encode interleaved float PCM to a compressed audio file.  The container
// is guessed from the filename (mp3/ogg/opus/m4a/flac/...), the codec from
// the container's default (overridable via codec_name).  Muxers write
// their gapless metadata (e.g. the mp3 Xing/LAME tag) so round trips are
// sample-aligned.  Returns 0 on success, a positive error code otherwise.
// Also the real encoder that validates the in-repo mp3 decoder
// (tests/test_torch_native.py).
int adec_encode_file(const char* path, const float* pcm, int64_t n_samples,
                     int sample_rate, int nch, int bitrate_kbps,
                     const char* codec_name) {
  av_log_set_level(AV_LOG_ERROR);
  AVFormatContext* fmt = nullptr;
  if (avformat_alloc_output_context2(&fmt, nullptr, nullptr, path) < 0 || !fmt)
    return 6;
  const AVCodec* codec =
      (codec_name && codec_name[0])
          ? avcodec_find_encoder_by_name(codec_name)
          : avcodec_find_encoder(fmt->oformat->audio_codec);
  if (!codec) {
    avformat_free_context(fmt);
    return 1;
  }
  AVStream* st = avformat_new_stream(fmt, nullptr);
  AVCodecContext* ctx = avcodec_alloc_context3(codec);
  ctx->sample_rate = sample_rate;
  av_channel_layout_default(&ctx->ch_layout, nch);
  // pick a sample format the encoder supports (prefer planar float)
  ctx->sample_fmt = AV_SAMPLE_FMT_FLTP;
  if (codec->sample_fmts) {
    bool has_fltp = false;
    for (const enum AVSampleFormat* f = codec->sample_fmts;
         *f != AV_SAMPLE_FMT_NONE; f++)
      if (*f == AV_SAMPLE_FMT_FLTP) has_fltp = true;
    if (!has_fltp) ctx->sample_fmt = codec->sample_fmts[0];
  }
  ctx->bit_rate = (int64_t)bitrate_kbps * 1000;
  ctx->time_base = {1, sample_rate};
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
    ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  int rc = 0;
  if (avcodec_open2(ctx, codec, nullptr) < 0) rc = 2;
  if (!rc) {
    avcodec_parameters_from_context(st->codecpar, ctx);
    st->time_base = ctx->time_base;
    if (avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0) rc = 3;
  }
  if (!rc && avformat_write_header(fmt, nullptr) < 0) rc = 7;
  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  int64_t pos = 0;
  auto drain = [&]() {
    while (avcodec_receive_packet(ctx, pkt) >= 0) {
      av_packet_rescale_ts(pkt, ctx->time_base, st->time_base);
      pkt->stream_index = st->index;
      av_interleaved_write_frame(fmt, pkt);
    }
  };
  while (pos < n_samples && !rc) {
    int chunk = ctx->frame_size > 0 ? ctx->frame_size : 1152;
    if (pos + chunk > n_samples) chunk = (int)(n_samples - pos);
    frame->nb_samples = chunk;
    frame->format = ctx->sample_fmt;
    av_channel_layout_copy(&frame->ch_layout, &ctx->ch_layout);
    frame->sample_rate = sample_rate;
    if (av_frame_get_buffer(frame, 0) < 0) { rc = 4; break; }
    if (ctx->sample_fmt == AV_SAMPLE_FMT_FLTP) {
      for (int c = 0; c < nch; c++) {
        float* dst = (float*)frame->data[c];
        for (int i = 0; i < chunk; i++) dst[i] = pcm[(pos + i) * nch + c];
      }
    } else if (ctx->sample_fmt == AV_SAMPLE_FMT_FLT) {
      float* dst = (float*)frame->data[0];
      for (int i = 0; i < chunk * nch; i++) dst[i] = pcm[pos * nch + i];
    } else if (ctx->sample_fmt == AV_SAMPLE_FMT_S16P) {
      for (int c = 0; c < nch; c++) {
        int16_t* dst = (int16_t*)frame->data[c];
        for (int i = 0; i < chunk; i++) {
          float v = pcm[(pos + i) * nch + c];
          v = v < -1.f ? -1.f : (v > 1.f ? 1.f : v);
          dst[i] = (int16_t)(v * 32767.f);
        }
      }
    } else if (ctx->sample_fmt == AV_SAMPLE_FMT_S16) {
      int16_t* dst = (int16_t*)frame->data[0];
      for (int i = 0; i < chunk * nch; i++) {
        float v = pcm[pos * nch + i];
        v = v < -1.f ? -1.f : (v > 1.f ? 1.f : v);
        dst[i] = (int16_t)(v * 32767.f);
      }
    } else { rc = 8; break; }
    frame->pts = pos;
    if (avcodec_send_frame(ctx, frame) < 0) rc = 5;
    drain();
    av_frame_unref(frame);
    pos += chunk;
  }
  if (!rc) {
    avcodec_send_frame(ctx, nullptr);
    drain();
    av_write_trailer(fmt);
  }
  av_frame_free(&frame);
  av_packet_free(&pkt);
  avcodec_free_context(&ctx);
  if (fmt->pb) avio_closep(&fmt->pb);
  avformat_free_context(fmt);
  return rc;
}

int adec_encode_mp3(const char* path, const float* pcm, int64_t n_samples,
                    int sample_rate, int nch, int bitrate_kbps) {
  return adec_encode_file(path, pcm, n_samples, sample_rate, nch,
                          bitrate_kbps, "libmp3lame");
}

}  // extern "C"
