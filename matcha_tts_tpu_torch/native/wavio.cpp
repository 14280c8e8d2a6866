// Batch WAV reader for the training data pipeline.
//
// RIFF/WAVE parsing, PCM to float32 conversion and zero padding, fanned out
// over std::thread and decoded straight into the (B, T) batch buffer: one
// allocation and no array per item on the Python side.
//
// Encodings (those `data/dataset.py::load_wav` reads through scipy): PCM16
// (/32768), PCM24 (left-justified to 32 bits, /2^31), PCM32 (/2^31), uint8
// ((x-128)/128), IEEE float32 and float64, each also under a
// WAVE_FORMAT_EXTENSIBLE header (its sub-format read in place of the format
// tag).  Several channels are averaged.  Anything else (other bit depths,
// compressed formats) is status 4.
//
// C interface (ctypes, `native/wavio_native.py`):
//   wav_header_info(path, *n_samples, *sample_rate) -> status
//   wav_load_batch(paths, n, out, cap, lens, srs, statuses, n_threads)
//
// Status codes: 0 ok, 1 open failed, 2 not RIFF/WAVE, 3 no fmt/data,
//               4 unsupported encoding.
//
// Built by `native/build.py` (g++ -O3 -shared -fPIC -std=c++17 -pthread).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint16_t kExtensible = 0xFFFE;

struct WavInfo {
  uint16_t format = 0;       // 1 = PCM, 3 = IEEE float (an extensible
                             // header's sub-format)
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  long data_offset = 0;
  uint32_t data_bytes = 0;
};

int parse_header(std::FILE* f, WavInfo* info) {
  char id[4];
  uint32_t sz;
  if (std::fread(id, 1, 4, f) != 4 || std::memcmp(id, "RIFF", 4) != 0)
    return 2;
  if (std::fread(&sz, 4, 1, f) != 1) return 2;
  if (std::fread(id, 1, 4, f) != 4 || std::memcmp(id, "WAVE", 4) != 0)
    return 2;
  bool have_fmt = false, have_data = false;
  while (!have_fmt || !have_data) {
    if (std::fread(id, 1, 4, f) != 4 || std::fread(&sz, 4, 1, f) != 1)
      break;
    if (std::memcmp(id, "fmt ", 4) == 0) {
      // the 16 bytes of every fmt chunk, then for WAVE_FORMAT_EXTENSIBLE
      // cbSize, valid bits, channel mask and the sub-format GUID, whose
      // first two bytes are the format tag
      uint8_t buf[40];
      if (sz < 16 || std::fread(buf, 1, 16, f) != 16) return 3;
      std::memcpy(&info->format, buf + 0, 2);
      std::memcpy(&info->channels, buf + 2, 2);
      std::memcpy(&info->sample_rate, buf + 4, 4);
      std::memcpy(&info->bits, buf + 14, 2);
      uint32_t read = 16;
      if (info->format == kExtensible) {
        if (sz < 40 || std::fread(buf + 16, 1, 24, f) != 24) return 4;
        std::memcpy(&info->format, buf + 24, 2);
        read = 40;
      }
      if (sz > read) std::fseek(f, ((sz + 1) & ~1u) - read, SEEK_CUR);
      have_fmt = true;
    } else if (std::memcmp(id, "data", 4) == 0) {
      info->data_offset = std::ftell(f);
      info->data_bytes = sz;
      have_data = true;
      std::fseek(f, (sz + 1) & ~1u, SEEK_CUR);  // chunks are 2-byte aligned
    } else {
      std::fseek(f, (sz + 1) & ~1u, SEEK_CUR);
    }
  }
  if (!have_fmt || !have_data) return 3;
  bool pcm_ok = info->format == 1 && (info->bits == 8 || info->bits == 16 ||
                                      info->bits == 24 || info->bits == 32);
  bool float_ok = info->format == 3 && (info->bits == 32 || info->bits == 64);
  if (!(pcm_ok || float_ok) || info->channels == 0) return 4;
  return 0;
}

int load_one(const char* path, float* out, int64_t cap, int64_t* len,
             int32_t* sr) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  WavInfo info;
  int rc = parse_header(f, &info);
  if (rc != 0) {
    std::fclose(f);
    return rc;
  }
  *sr = static_cast<int32_t>(info.sample_rate);
  const int64_t bytes_per = info.bits / 8;
  const int64_t frames = info.data_bytes / (bytes_per * info.channels);
  const int64_t n = frames < cap ? frames : cap;
  *len = frames;

  std::fseek(f, info.data_offset, SEEK_SET);
  std::vector<uint8_t> raw(static_cast<size_t>(n) * bytes_per * info.channels);
  size_t got = std::fread(raw.data(), 1, raw.size(), f);
  std::fclose(f);
  const int64_t got_frames =
      static_cast<int64_t>(got) / (bytes_per * info.channels);
  const float inv_ch = 1.0f / info.channels;

  if (info.channels == 1 && info.format == 1 && info.bits == 16) {
    // the common case (LJSpeech and most corpora): mono PCM16, a flat
    // loop that g++ vectorises
    const int16_t* s = reinterpret_cast<const int16_t*>(raw.data());
    constexpr float kInv = 1.0f / 32768.0f;
    for (int64_t i = 0; i < got_frames; ++i) out[i] = s[i] * kInv;
    for (int64_t i = got_frames; i < cap; ++i) out[i] = 0.0f;
    return 0;
  }

  for (int64_t i = 0; i < got_frames; ++i) {
    float acc = 0.0f;
    for (int c = 0; c < info.channels; ++c) {
      const uint8_t* p = raw.data() + (i * info.channels + c) * bytes_per;
      float v;
      if (info.format == 3 && info.bits == 64) {  // IEEE float64
        double d;
        std::memcpy(&d, p, 8);
        v = static_cast<float>(d);
      } else if (info.format == 3) {  // IEEE float32
        std::memcpy(&v, p, 4);
      } else if (info.bits == 16) {
        int16_t s;
        std::memcpy(&s, p, 2);
        v = s / 32768.0f;
      } else if (info.bits == 24) {  // left-justified to 32 bits, as scipy
        const int32_t s = static_cast<int32_t>(
            (static_cast<uint32_t>(p[0]) << 8) | (static_cast<uint32_t>(p[1]) << 16) |
            (static_cast<uint32_t>(p[2]) << 24));
        v = static_cast<float>(s / 2147483648.0);
      } else if (info.bits == 32) {
        int32_t s;
        std::memcpy(&s, p, 4);
        v = static_cast<float>(s / 2147483648.0);
      } else {  // uint8
        v = (p[0] - 128.0f) / 128.0f;
      }
      acc += v;
    }
    out[i] = acc * inv_ch;
  }
  for (int64_t i = got_frames; i < cap; ++i) out[i] = 0.0f;
  return 0;
}

}  // namespace

extern "C" {

int wav_header_info(const char* path, int64_t* n_samples, int32_t* sr) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  WavInfo info;
  int rc = parse_header(f, &info);
  std::fclose(f);
  if (rc != 0) return rc;
  *n_samples = info.data_bytes / ((info.bits / 8) * info.channels);
  *sr = static_cast<int32_t>(info.sample_rate);
  return 0;
}

void wav_load_batch(const char** paths, int64_t n, float* out, int64_t cap,
                    int64_t* lens, int32_t* srs, int32_t* statuses,
                    int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next(0);
  auto work = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      statuses[i] =
          load_one(paths[i], out + i * cap, cap, &lens[i], &srs[i]);
    }
  };
  if (n_threads == 1 || n == 1) {
    work();
    return;
  }
  std::vector<std::thread> pool;
  int32_t use = n_threads < n ? n_threads : static_cast<int32_t>(n);
  pool.reserve(use);
  for (int32_t t = 0; t < use; ++t) pool.emplace_back(work);
  for (auto& th : pool) th.join();
}

}  // extern "C"
