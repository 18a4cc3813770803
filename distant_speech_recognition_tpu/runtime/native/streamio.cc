// Native host-side audio stream runtime.
//
// Native counterpart of the reference's C++ stream/IO layer
// (feature/feature.cc SampleFeature/IterativeSampleFeature + common/
// mach_ind_io.cc): high-throughput WAV ingest, int16 -> normalized float32
// conversion, de-interleaving, block framing with zero padding, and a
// streaming block reader with O(1) memory — everything the host must do to
// feed utterance batches to the device without Python overhead.
//
// Exposed as a plain C ABI for ctypes binding (no pybind11 in this image).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// WAV parsing (16-bit PCM RIFF)
// ---------------------------------------------------------------------------

struct WavInfo {
  int32_t num_channels;
  int32_t sample_rate;
  int32_t bits_per_sample;
  int64_t num_frames;     // samples per channel
  int64_t data_offset;    // byte offset of PCM payload
};

static int read_wav_header(FILE* f, WavInfo* info) {
  uint8_t hdr[12];
  if (fread(hdr, 1, 12, f) != 12) return -1;
  if (memcmp(hdr, "RIFF", 4) != 0 || memcmp(hdr + 8, "WAVE", 4) != 0) return -2;

  uint8_t chunk[8];
  int have_fmt = 0;
  while (fread(chunk, 1, 8, f) == 8) {
    uint32_t size;
    memcpy(&size, chunk + 4, 4);
    if (memcmp(chunk, "fmt ", 4) == 0) {
      uint8_t fmt[16];
      if (size < 16 || fread(fmt, 1, 16, f) != 16) return -3;
      uint16_t channels, bits;
      uint32_t rate;
      memcpy(&channels, fmt + 2, 2);
      memcpy(&rate, fmt + 4, 4);
      memcpy(&bits, fmt + 14, 2);
      info->num_channels = channels;
      info->sample_rate = (int32_t)rate;
      info->bits_per_sample = bits;
      if (size > 16) fseek(f, (long)(size - 16), SEEK_CUR);
      have_fmt = 1;
    } else if (memcmp(chunk, "data", 4) == 0) {
      if (!have_fmt) return -4;
      info->data_offset = ftell(f);
      info->num_frames =
          (int64_t)size / (info->num_channels * (info->bits_per_sample / 8));
      return 0;
    } else {
      fseek(f, (long)size + (size & 1), SEEK_CUR);
    }
  }
  return -5;
}

// Query header only.  Returns 0 on success.
int wav_info(const char* path, int32_t* num_channels, int32_t* sample_rate,
             int64_t* num_frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  int rc = read_wav_header(f, &info);
  fclose(f);
  if (rc != 0) return rc;
  *num_channels = info.num_channels;
  *sample_rate = info.sample_rate;
  *num_frames = info.num_frames;
  return 0;
}

// Read the whole file into a planar float32 buffer out[ch][frame], caller
// allocated with num_channels*num_frames floats.  int16 normalized by 1/32768
// (libsndfile convention, matching feature/feature.cc:241-269).
int wav_read_planar_f32(const char* path, float* out, int64_t capacity) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  int rc = read_wav_header(f, &info);
  if (rc != 0) { fclose(f); return rc; }
  if (info.bits_per_sample != 16) { fclose(f); return -6; }
  const int64_t C = info.num_channels, T = info.num_frames;
  if (capacity < C * T) { fclose(f); return -7; }

  const int64_t CHUNK = 1 << 16;
  std::vector<int16_t> buf((size_t)(CHUNK * C));
  int64_t frame = 0;
  fseek(f, (long)info.data_offset, SEEK_SET);
  while (frame < T) {
    int64_t want = (T - frame < CHUNK) ? (T - frame) : CHUNK;
    size_t got = fread(buf.data(), sizeof(int16_t) * (size_t)C, (size_t)want, f);
    if (got == 0) break;
    const float scale = 1.0f / 32768.0f;
    for (int64_t t = 0; t < (int64_t)got; ++t)
      for (int64_t c = 0; c < C; ++c)
        out[c * T + frame + t] = (float)buf[(size_t)(t * C + c)] * scale;
    frame += (int64_t)got;
  }
  fclose(f);
  // zero any tail if file was truncated
  for (int64_t c = 0; c < C; ++c)
    for (int64_t t = frame; t < T; ++t) out[c * T + t] = 0.0f;
  return 0;
}

// Write planar float32 -> 16-bit PCM WAV.
int wav_write_planar_f32(const char* path, const float* data, int32_t num_channels,
                         int64_t num_frames, int32_t sample_rate) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  const int64_t data_len = num_frames * num_channels * 2;
  uint8_t hdr[44];
  memcpy(hdr, "RIFF", 4);
  uint32_t riff = (uint32_t)(36 + data_len);
  memcpy(hdr + 4, &riff, 4);
  memcpy(hdr + 8, "WAVEfmt ", 8);
  uint32_t fmt_size = 16;
  memcpy(hdr + 16, &fmt_size, 4);
  uint16_t pcm = 1, ch = (uint16_t)num_channels, bits = 16,
           block = (uint16_t)(num_channels * 2);
  uint32_t rate = (uint32_t)sample_rate, bps = rate * block;
  memcpy(hdr + 20, &pcm, 2);
  memcpy(hdr + 22, &ch, 2);
  memcpy(hdr + 24, &rate, 4);
  memcpy(hdr + 28, &bps, 4);
  memcpy(hdr + 32, &block, 2);
  memcpy(hdr + 34, &bits, 2);
  memcpy(hdr + 36, "data", 4);
  uint32_t dl = (uint32_t)data_len;
  memcpy(hdr + 40, &dl, 4);
  fwrite(hdr, 1, 44, f);

  const int64_t CHUNK = 1 << 16;
  std::vector<int16_t> buf((size_t)(CHUNK * num_channels));
  for (int64_t start = 0; start < num_frames; start += CHUNK) {
    int64_t n = (num_frames - start < CHUNK) ? (num_frames - start) : CHUNK;
    for (int64_t t = 0; t < n; ++t)
      for (int64_t c = 0; c < num_channels; ++c) {
        float v = data[c * num_frames + start + t] * 32768.0f;
        if (v > 32767.0f) v = 32767.0f;
        if (v < -32768.0f) v = -32768.0f;
        buf[(size_t)(t * num_channels + c)] = (int16_t)(v >= 0 ? v + 0.5f : v - 0.5f);
      }
    fwrite(buf.data(), sizeof(int16_t) * (size_t)num_channels, (size_t)n, f);
  }
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// Threaded batch loader (the data-loader role the reference lacks: read a
// whole utterance batch into a preallocated [B, C, T_pad] tensor in parallel,
// zero-padded / truncated to a fixed length for static device shapes).
// ---------------------------------------------------------------------------

// Read one file into out[C][T_pad]; channels beyond the file's are zeroed,
// frames are zero-padded or truncated to T_pad.  Returns 0 on success.
static int read_one_padded(const char* path, float* out, int32_t C_expect,
                           int64_t T_pad) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  int rc = read_wav_header(f, &info);
  if (rc != 0) { fclose(f); return rc; }
  if (info.bits_per_sample != 16) { fclose(f); return -6; }
  const int64_t C = info.num_channels;
  const int64_t T = info.num_frames < T_pad ? info.num_frames : T_pad;
  const int64_t Cw = C < C_expect ? C : C_expect;

  memset(out, 0, (size_t)(C_expect * T_pad) * sizeof(float));
  const int64_t CHUNK = 1 << 16;
  std::vector<int16_t> buf((size_t)(CHUNK * C));
  int64_t frame = 0;
  fseek(f, (long)info.data_offset, SEEK_SET);
  const float scale = 1.0f / 32768.0f;
  while (frame < T) {
    int64_t want = (T - frame < CHUNK) ? (T - frame) : CHUNK;
    size_t got = fread(buf.data(), sizeof(int16_t) * (size_t)C, (size_t)want, f);
    if (got == 0) break;
    for (int64_t t = 0; t < (int64_t)got; ++t)
      for (int64_t c = 0; c < Cw; ++c)
        out[c * T_pad + frame + t] = (float)buf[(size_t)(t * C + c)] * scale;
    frame += (int64_t)got;
  }
  fclose(f);
  return 0;
}

// Read n_files WAVs concurrently into out[b][C_expect][T_pad] (caller
// allocated, n_files*C_expect*T_pad floats).  paths: array of C strings.
// num_threads <= 0 selects the hardware concurrency.  Returns 0 on success,
// or the first nonzero per-file error code.
int batch_read_planar_f32(const char** paths, int32_t n_files, float* out,
                          int32_t C_expect, int64_t T_pad,
                          int32_t num_threads) {
  if (n_files <= 0) return 0;
  int nt = num_threads > 0 ? num_threads
                           : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > n_files) nt = n_files;
  std::atomic<int32_t> next(0);
  std::atomic<int> err(0);
  const int64_t stride = (int64_t)C_expect * T_pad;
  auto worker = [&]() {
    for (;;) {
      int32_t b = next.fetch_add(1);
      if (b >= n_files) break;
      int rc = read_one_padded(paths[b], out + (int64_t)b * stride, C_expect,
                               T_pad);
      if (rc != 0) {
        int expected = 0;
        err.compare_exchange_strong(expected, rc);
      }
    }
  };
  std::vector<std::thread> pool;
  pool.reserve((size_t)nt);
  for (int i = 0; i < nt; ++i) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return err.load();
}

// ---------------------------------------------------------------------------
// Block framing (SampleFeature::next semantics, feature/feature.cc:605-648)
// ---------------------------------------------------------------------------

// Frame a mono signal into zero-padded blocks: out[n][block_len] with
// n = ceil(T / shift_len).  Returns n.
int64_t frame_blocks_f32(const float* x, int64_t T, int32_t block_len,
                         int32_t shift_len, float* out, int64_t out_capacity) {
  if (shift_len <= 0 || block_len <= 0) return -1;
  int64_t n = (T + shift_len - 1) / shift_len;
  if (out_capacity < n * block_len) return -2;
  for (int64_t i = 0; i < n; ++i) {
    int64_t start = i * shift_len;
    int64_t avail = T - start;
    int64_t copy = avail < block_len ? (avail > 0 ? avail : 0) : block_len;
    memcpy(out + i * block_len, x + start, (size_t)copy * sizeof(float));
    if (copy < block_len)
      memset(out + i * block_len + copy, 0, (size_t)(block_len - copy) * sizeof(float));
  }
  return n;
}

// ---------------------------------------------------------------------------
// Streaming reader (IterativeSingleChannelSampleFeature equivalent,
// feature/feature.h:237-322): O(1)-memory incremental block reads.
// ---------------------------------------------------------------------------

struct StreamReader {
  FILE* f;
  WavInfo info;
  int64_t frame_pos;
  int32_t channel;
};

void* stream_open(const char* path, int32_t channel) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  StreamReader* r = new StreamReader();
  r->f = f;
  if (read_wav_header(f, &r->info) != 0 || r->info.bits_per_sample != 16 ||
      channel >= r->info.num_channels) {
    fclose(f);
    delete r;
    return nullptr;
  }
  r->frame_pos = 0;
  r->channel = channel < 0 ? 0 : channel;
  return r;
}

// Read up to block_len mono samples; zero-pads a final partial block.
// Returns samples valid before padding, 0 at EOF, negative on error.
int64_t stream_read_block(void* handle, float* out, int32_t block_len) {
  StreamReader* r = (StreamReader*)handle;
  if (!r) return -1;
  const int64_t C = r->info.num_channels;
  int64_t remain = r->info.num_frames - r->frame_pos;
  if (remain <= 0) return 0;
  int64_t want = remain < block_len ? remain : block_len;
  std::vector<int16_t> buf((size_t)(want * C));
  fseek(r->f, (long)(r->info.data_offset + r->frame_pos * C * 2), SEEK_SET);
  size_t got = fread(buf.data(), sizeof(int16_t) * (size_t)C, (size_t)want, r->f);
  const float scale = 1.0f / 32768.0f;
  for (int64_t t = 0; t < (int64_t)got; ++t)
    out[t] = (float)buf[(size_t)(t * C + r->channel)] * scale;
  for (int64_t t = (int64_t)got; t < block_len; ++t) out[t] = 0.0f;
  r->frame_pos += (int64_t)got;
  return (int64_t)got;
}

void stream_close(void* handle) {
  StreamReader* r = (StreamReader*)handle;
  if (r) {
    fclose(r->f);
    delete r;
  }
}

// ---------------------------------------------------------------------------
// Sample-rate conversion (SamplerateConversionFeature, feature/feature.h:
// 775-809 — the reference wraps libsamplerate's SRC_SINC converters).
// Windowed-sinc interpolation with a Blackman-Harris window; the cutoff is
// scaled below 1 for downsampling so the kernel doubles as the anti-alias
// filter.  Multi-threaded over output ranges.
// ---------------------------------------------------------------------------

static double bh_window(double u) {  // u in [-1, 1]
  const double a0 = 0.35875, a1 = 0.48829, a2 = 0.14128, a3 = 0.01168;
  const double pi = 3.14159265358979323846;
  double t = 0.5 * (u + 1.0);  // [0, 1]
  return a0 - a1 * cos(2.0 * pi * t) + a2 * cos(4.0 * pi * t) -
         a3 * cos(6.0 * pi * t);
}

static double sinc_pi(double x) {
  const double pi = 3.14159265358979323846;
  if (x > -1e-12 && x < 1e-12) return 1.0;
  return sin(pi * x) / (pi * x);
}

// Resample a mono float signal from src_rate to dst_rate.  half_taps is the
// one-sided kernel width at the *output* Nyquist (e.g. 32); out must hold
// floor(n_in * dst / src) samples.  Returns the output length, or negative
// on error.  num_threads <= 0 selects hardware concurrency.
int64_t resample_sinc_f32(const float* in, int64_t n_in, int32_t src_rate,
                          int32_t dst_rate, float* out, int64_t out_capacity,
                          int32_t half_taps, int32_t num_threads) {
  if (n_in <= 0 || src_rate <= 0 || dst_rate <= 0 || half_taps <= 0) return -1;
  const int64_t n_out = n_in * (int64_t)dst_rate / src_rate;
  if (out_capacity < n_out) return -2;
  const double ratio = (double)src_rate / (double)dst_rate;  // input step
  const double cutoff = ratio > 1.0 ? 1.0 / ratio : 1.0;     // anti-alias
  const double width = (double)half_taps / cutoff;           // input samples

  int nt = num_threads > 0 ? num_threads
                           : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  const int64_t min_chunk = 4096;
  if (nt > (int)((n_out + min_chunk - 1) / min_chunk))
    nt = (int)((n_out + min_chunk - 1) / min_chunk);
  if (nt < 1) nt = 1;

  auto worker = [&](int64_t t0, int64_t t1) {
    for (int64_t t = t0; t < t1; ++t) {
      const double p = (double)t * ratio;  // position in input samples
      int64_t k0 = (int64_t)ceil(p - width);
      int64_t k1 = (int64_t)floor(p + width);
      if (k0 < 0) k0 = 0;
      if (k1 > n_in - 1) k1 = n_in - 1;
      double acc = 0.0, wsum = 0.0;
      for (int64_t k = k0; k <= k1; ++k) {
        const double d = p - (double)k;
        const double w = sinc_pi(cutoff * d) * bh_window(d / width);
        acc += w * (double)in[k];
        wsum += w;
      }
      // normalize by the weight sum: unity DC gain regardless of the
      // fractional phase or edge truncation of the kernel
      out[t] = wsum > 1e-12 ? (float)(acc / wsum) : 0.0f;
    }
  };
  if (nt == 1) {
    worker(0, n_out);
  } else {
    std::vector<std::thread> pool;
    pool.reserve((size_t)nt);
    const int64_t per = (n_out + nt - 1) / nt;
    for (int i = 0; i < nt; ++i) {
      int64_t t0 = (int64_t)i * per;
      int64_t t1 = t0 + per < n_out ? t0 + per : n_out;
      if (t0 >= t1) break;
      pool.emplace_back(worker, t0, t1);
    }
    for (auto& t : pool) t.join();
  }
  return n_out;
}

}  // extern "C"
