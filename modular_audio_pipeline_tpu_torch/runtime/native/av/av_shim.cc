// In-process libav* decode/encode shim.
//
// Lossy-container ingest without an ffmpeg binary: decode happens in-process against the system libavformat/libavcodec
// shared libraries, so `.ogg` / `.m4a` / `.mp4` / `.opus` / `.webm` inputs
// work with no ffmpeg executable on PATH. First-party decoders (WAV RIFF,
// FLAC, MPEG-1 Layer III in ../flac_decode.cc and ../mp3_decode.cc) stay
// the primary path for their formats; this shim covers the long tail and
// doubles as the fixture encoder for the ingest test suite.
//
// Built as a SEPARATE shared object (libmap_av.so) so environments without
// libav dev libraries lose only the exotic-container path, never the core
// native runtime.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

namespace {

// Accumulates interleaved float32 output of a decode run.
struct DecodeSink {
  std::vector<float> data;
  int sr = 0;
  int ch = 0;
};

// Convert one decoded frame to interleaved f32 at its native rate and
// append to the sink. The SwrContext is (re)created on layout change.
int append_frame(DecodeSink &sink, SwrContext *&swr, const AVFrame *frame) {
  if (sink.sr == 0) {
    sink.sr = frame->sample_rate;
    sink.ch = frame->ch_layout.nb_channels;
  }
  if (swr == nullptr) {
    AVChannelLayout out_layout;
    av_channel_layout_default(&out_layout, sink.ch);
    // ffmpeg-5.x swresample takes a non-const layout pointer; it only reads
    AVChannelLayout in_layout;
    av_channel_layout_copy(&in_layout, &frame->ch_layout);
    int rc = swr_alloc_set_opts2(
        &swr, &out_layout, AV_SAMPLE_FMT_FLT, sink.sr,
        &in_layout, (AVSampleFormat)frame->format, frame->sample_rate,
        0, nullptr);
    av_channel_layout_uninit(&in_layout);
    av_channel_layout_uninit(&out_layout);
    if (rc < 0 || swr_init(swr) < 0) return -1;
  }
  // rate is passed through unchanged, so out count == in count (+ state)
  int max_out = frame->nb_samples + 256;
  size_t base = sink.data.size();
  sink.data.resize(base + (size_t)max_out * sink.ch);
  uint8_t *out_planes[1] = {
      reinterpret_cast<uint8_t *>(sink.data.data() + base)};
  int got = swr_convert(swr, out_planes, max_out,
                        const_cast<const uint8_t **>(frame->extended_data),
                        frame->nb_samples);
  if (got < 0) return -1;
  sink.data.resize(base + (size_t)got * sink.ch);
  return 0;
}

}  // namespace

extern "C" {

// Decode the best audio stream of `path` to interleaved float32 at the
// stream's native sample rate and channel count. On success returns the
// number of frames (per-channel samples) written, sets *out (caller frees
// with av_shim_free), *sr and *ch. Negative return = error:
//   -1 open/probe failed     -2 no audio stream
//   -3 decoder unavailable   -4 decode error
int64_t av_shim_decode(const char *path, float **out, int32_t *sr,
                       int32_t *ch) {
  AVFormatContext *fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return -1;
  if (avformat_find_stream_info(fmt, nullptr) < 0) {
    avformat_close_input(&fmt);
    return -1;
  }
  const AVCodec *codec = nullptr;
  int stream_idx =
      av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
  if (stream_idx < 0 || codec == nullptr) {
    avformat_close_input(&fmt);
    return stream_idx < 0 ? -2 : -3;
  }
  AVCodecContext *dec = avcodec_alloc_context3(codec);
  if (dec == nullptr ||
      avcodec_parameters_to_context(dec, fmt->streams[stream_idx]->codecpar) <
          0 ||
      avcodec_open2(dec, codec, nullptr) < 0) {
    if (dec) avcodec_free_context(&dec);
    avformat_close_input(&fmt);
    return -3;
  }

  DecodeSink sink;
  SwrContext *swr = nullptr;
  AVPacket *pkt = av_packet_alloc();
  AVFrame *frame = av_frame_alloc();
  int err = 0;

  auto drain = [&]() {
    while (true) {
      int rc = avcodec_receive_frame(dec, frame);
      if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return 0;
      if (rc < 0) {
        // corrupt packet (e.g. trailing tag bytes muxed into the last
        // packet): reset and keep what decoded, like the ffmpeg CLI
        avcodec_flush_buffers(dec);
        return 0;
      }
      if (append_frame(sink, swr, frame) < 0) return -4;
    }
  };

  while (err == 0 && av_read_frame(fmt, pkt) >= 0) {
    if (pkt->stream_index == stream_idx) {
      if (avcodec_send_packet(dec, pkt) == 0) err = drain();
      // unsendable packets are skipped, matching ffmpeg CLI leniency
    }
    av_packet_unref(pkt);
  }
  if (err == 0) {
    avcodec_send_packet(dec, nullptr);  // flush
    err = drain();
  }
  // flush the resampler's internal delay line
  if (err == 0 && swr != nullptr) {
    size_t base = sink.data.size();
    sink.data.resize(base + 4096 * (size_t)sink.ch);
    uint8_t *out_planes[1] = {
        reinterpret_cast<uint8_t *>(sink.data.data() + base)};
    int got = swr_convert(swr, out_planes, 4096, nullptr, 0);
    sink.data.resize(base + (size_t)(got > 0 ? got : 0) * sink.ch);
  }

  av_frame_free(&frame);
  av_packet_free(&pkt);
  if (swr) swr_free(&swr);
  avcodec_free_context(&dec);
  avformat_close_input(&fmt);

  if (err < 0) return err;
  if (sink.sr == 0 || sink.data.empty()) return -4;

  float *buf = static_cast<float *>(malloc(sink.data.size() * sizeof(float)));
  if (buf == nullptr) return -4;
  memcpy(buf, sink.data.data(), sink.data.size() * sizeof(float));
  *out = buf;
  *sr = sink.sr;
  *ch = sink.ch;
  return (int64_t)(sink.data.size() / sink.ch);
}

void av_shim_free(float *p) { free(p); }

// Duration (seconds, from the container) + stream params without a full
// decode; mirrors ffprobe's summary fields. Returns 0 on success.
int32_t av_shim_probe(const char *path, double *duration, int32_t *sr,
                      int32_t *ch, int64_t *bit_rate, char *codec_name,
                      int32_t codec_name_cap) {
  AVFormatContext *fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return -1;
  if (avformat_find_stream_info(fmt, nullptr) < 0) {
    avformat_close_input(&fmt);
    return -1;
  }
  int stream_idx =
      av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, nullptr, 0);
  if (stream_idx < 0) {
    avformat_close_input(&fmt);
    return -2;
  }
  const AVStream *st = fmt->streams[stream_idx];
  *duration = fmt->duration > 0 ? fmt->duration / (double)AV_TIME_BASE
              : st->duration > 0
                  ? st->duration * av_q2d(st->time_base)
                  : 0.0;
  *sr = st->codecpar->sample_rate;
  *ch = st->codecpar->ch_layout.nb_channels;
  *bit_rate = fmt->bit_rate > 0 ? fmt->bit_rate : st->codecpar->bit_rate;
  const char *name = avcodec_get_name(st->codecpar->codec_id);
  snprintf(codec_name, codec_name_cap, "%s", name ? name : "unknown");
  avformat_close_input(&fmt);
  return 0;
}

// Encode interleaved float32 PCM into the container implied by `path`
// (fixture generation for the ingest tests). codec_name may be empty to
// use the container's default audio codec. Returns 0 on success:
//   -1 muxer/codec unavailable  -2 encoder setup failed  -3 io/encode failed
int32_t av_shim_encode(const char *path, const float *data, int64_t n_frames,
                       int32_t sr, int32_t ch, const char *codec_name) {
  AVFormatContext *fmt = nullptr;
  if (avformat_alloc_output_context2(&fmt, nullptr, nullptr, path) < 0 ||
      fmt == nullptr)
    return -1;

  const AVCodec *codec =
      (codec_name != nullptr && codec_name[0] != '\0')
          ? avcodec_find_encoder_by_name(codec_name)
          : avcodec_find_encoder(fmt->oformat->audio_codec);
  if (codec == nullptr) {
    avformat_free_context(fmt);
    return -1;
  }

  AVCodecContext *enc = avcodec_alloc_context3(codec);
  if (enc == nullptr) {
    avformat_free_context(fmt);
    return -2;
  }
  enc->sample_rate = sr;
  // some encoders (opus, aac) restrict sample rates; snap to the nearest
  if (codec->supported_samplerates) {
    int best = codec->supported_samplerates[0];
    for (const int *r = codec->supported_samplerates; *r; ++r)
      if (labs((long)*r - sr) < labs((long)best - sr)) best = *r;
    enc->sample_rate = best;
  }
  av_channel_layout_default(&enc->ch_layout, ch);
  enc->sample_fmt = codec->sample_fmts ? codec->sample_fmts[0] : AV_SAMPLE_FMT_FLTP;
  if (strstr(codec->name, "vorbis") != nullptr) {
    // libvorbis rejects fixed bitrates outside its per-rate window; its
    // quality (VBR) mode is valid at every rate/layout
    enc->flags |= AV_CODEC_FLAG_QSCALE;
    enc->global_quality = 5 * FF_QP2LAMBDA;
  } else {
    // keep within aac's 6144-bits/frame ceiling at low sample rates
    int64_t cap = (int64_t)enc->sample_rate * ch * 4;
    enc->bit_rate = cap < 128000 ? cap : 128000;
  }
  enc->time_base = AVRational{1, enc->sample_rate};
  enc->strict_std_compliance = FF_COMPLIANCE_EXPERIMENTAL;
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
    enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(enc, codec, nullptr) < 0) {
    avcodec_free_context(&enc);
    avformat_free_context(fmt);
    return -2;
  }

  AVStream *st = avformat_new_stream(fmt, nullptr);
  if (st == nullptr ||
      avcodec_parameters_from_context(st->codecpar, enc) < 0) {
    avcodec_free_context(&enc);
    avformat_free_context(fmt);
    return -2;
  }
  st->time_base = enc->time_base;

  int rc = 0;
  if (!(fmt->oformat->flags & AVFMT_NOFILE))
    rc = avio_open(&fmt->pb, path, AVIO_FLAG_WRITE);
  if (rc < 0 || avformat_write_header(fmt, nullptr) < 0) {
    avcodec_free_context(&enc);
    avformat_free_context(fmt);
    return -3;
  }

  // input is FLT interleaved at `sr`; convert into the encoder's sample
  // format and (possibly snapped) rate
  SwrContext *swr = nullptr;
  AVChannelLayout in_layout;
  av_channel_layout_default(&in_layout, ch);
  if (swr_alloc_set_opts2(&swr, &enc->ch_layout, enc->sample_fmt,
                          enc->sample_rate, &in_layout, AV_SAMPLE_FMT_FLT, sr,
                          0, nullptr) < 0 ||
      swr_init(swr) < 0) {
    av_channel_layout_uninit(&in_layout);
    avcodec_free_context(&enc);
    avformat_free_context(fmt);
    return -2;
  }
  av_channel_layout_uninit(&in_layout);

  AVPacket *pkt = av_packet_alloc();
  AVFrame *frame = av_frame_alloc();
  int chunk = enc->frame_size > 0 ? enc->frame_size : 1024;
  int64_t pts = 0;
  int err = 0;

  auto pump_packets = [&]() {
    while (true) {
      int r = avcodec_receive_packet(enc, pkt);
      if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return 0;
      if (r < 0) return -3;
      pkt->stream_index = st->index;
      av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
      if (av_interleaved_write_frame(fmt, pkt) < 0) return -3;
    }
  };

  // buffer the whole input in the resampler, then drain fixed-size
  // encoder frames (fixed-frame encoders reject short mid-stream frames;
  // the final partial frame is zero-padded — inaudible trailing silence)
  const uint8_t *in_planes[1] = {reinterpret_cast<const uint8_t *>(data)};
  if (swr_convert(swr, nullptr, 0, in_planes, (int)n_frames) < 0) err = -3;
  bool drained = false;
  while (err == 0 && !drained) {
    frame->nb_samples = chunk;
    frame->format = enc->sample_fmt;
    av_channel_layout_copy(&frame->ch_layout, &enc->ch_layout);
    frame->sample_rate = enc->sample_rate;
    if (av_frame_get_buffer(frame, 0) < 0 ||
        av_samples_set_silence(frame->extended_data, 0, chunk,
                               enc->ch_layout.nb_channels,
                               enc->sample_fmt) < 0) {
      err = -3;
      break;
    }
    int got = swr_convert(swr, frame->extended_data, chunk, nullptr, 0);
    if (got < 0) {
      err = -3;
      break;
    }
    if (got == 0) {
      av_frame_unref(frame);
      break;
    }
    drained = got < chunk;
    frame->pts = pts;
    pts += chunk;
    if (avcodec_send_frame(enc, frame) < 0) {
      err = -3;
      break;
    }
    err = pump_packets();
    av_frame_unref(frame);
  }
  if (err == 0) {
    avcodec_send_frame(enc, nullptr);  // flush
    err = pump_packets();
  }
  if (err == 0 && av_write_trailer(fmt) < 0) err = -3;

  av_frame_free(&frame);
  av_packet_free(&pkt);
  swr_free(&swr);
  avcodec_free_context(&enc);
  if (!(fmt->oformat->flags & AVFMT_NOFILE) && fmt->pb) avio_closep(&fmt->pb);
  avformat_free_context(fmt);
  return err;
}

// 1 when an encoder with this name (or the default for this container
// path when name is empty) is available in the linked libavcodec.
int32_t av_shim_have_encoder(const char *name) {
  return avcodec_find_encoder_by_name(name) != nullptr ? 1 : 0;
}

}  // extern "C"
