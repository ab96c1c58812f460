// Native audio I/O runtime for audio_analysis_tpu.
//
// The data-loading counterpart of the device engine: decodes WAV files
// (PCM16 / PCM24 / PCM32 / float32 / float64) to float32 and, for bundles,
// decodes all taps in parallel worker threads directly into one padded
// (B, N_max, C) host buffer ready for device upload — replacing the
// reference's sequential per-tap scipy reads (bundle.py:56-68).
//
// C ABI (ctypes-friendly), see audio_analysis_tpu/io/native.py:
//   aa_read_wav_info(path, *frames, *channels, *sample_rate)
//   aa_read_wav_f32(path, out, capacity)       // interleaved frames*channels
//   aa_write_wav_pcm16(path, data, frames, channels, sample_rate)
//   aa_read_bundle_f32(paths, n, out, n_max, C, lengths, threads)
// All return 0 on success, negative error codes otherwise.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kErrOpen = -1;
constexpr int kErrFormat = -2;
constexpr int kErrUnsupported = -3;
constexpr int kErrCapacity = -4;
constexpr int kErrWrite = -5;

struct WavInfo {
    uint16_t format = 0;       // 1 = PCM, 3 = IEEE float
    uint16_t channels = 0;
    uint32_t sample_rate = 0;
    uint16_t bits_per_sample = 0;
    int64_t data_offset = 0;   // byte offset of sample data
    int64_t data_bytes = 0;
    int64_t frames = 0;
};

bool read_exact(std::ifstream& f, void* dst, size_t n) {
    f.read(static_cast<char*>(dst), static_cast<std::streamsize>(n));
    return static_cast<size_t>(f.gcount()) == n;
}

// Walk RIFF chunks to find fmt + data. Tolerates extra chunks (LIST, fact…).
int probe_wav(const std::string& path, WavInfo& info) {
    std::ifstream f(path, std::ios::binary);
    if (!f) return kErrOpen;

    char tag[4];
    uint32_t riff_size = 0;
    if (!read_exact(f, tag, 4) || std::memcmp(tag, "RIFF", 4) != 0) return kErrFormat;
    if (!read_exact(f, &riff_size, 4)) return kErrFormat;
    if (!read_exact(f, tag, 4) || std::memcmp(tag, "WAVE", 4) != 0) return kErrFormat;

    bool have_fmt = false, have_data = false;
    while (!(have_fmt && have_data)) {
        char chunk_id[4];
        uint32_t chunk_size = 0;
        if (!read_exact(f, chunk_id, 4) || !read_exact(f, &chunk_size, 4)) break;

        if (std::memcmp(chunk_id, "fmt ", 4) == 0) {
            // chunk_size is untrusted 32-bit input: cap before allocating
            // (a corrupt header could otherwise request a ~4 GB buffer).
            constexpr uint32_t kMaxFmtChunkBytes = 64 * 1024;
            if (chunk_size < 16 || chunk_size > kMaxFmtChunkBytes) return kErrFormat;
            std::vector<char> fmt(chunk_size);
            if (!read_exact(f, fmt.data(), chunk_size)) return kErrFormat;
            if (chunk_size & 1) f.seekg(1, std::ios::cur);  // RIFF pad byte
            std::memcpy(&info.format, fmt.data() + 0, 2);
            std::memcpy(&info.channels, fmt.data() + 2, 2);
            std::memcpy(&info.sample_rate, fmt.data() + 4, 4);
            std::memcpy(&info.bits_per_sample, fmt.data() + 14, 2);
            if (info.format == 0xFFFE && chunk_size >= 40) {
                // WAVE_FORMAT_EXTENSIBLE: real format in the GUID prefix
                uint16_t sub = 0;
                std::memcpy(&sub, fmt.data() + 24, 2);
                info.format = sub;
            }
            have_fmt = true;
        } else if (std::memcmp(chunk_id, "data", 4) == 0) {
            info.data_offset = f.tellg();
            info.data_bytes = chunk_size;
            have_data = true;
            f.seekg(chunk_size + (chunk_size & 1), std::ios::cur);
        } else {
            f.seekg(chunk_size + (chunk_size & 1), std::ios::cur);
        }
        if (!f) break;
    }

    if (!have_fmt || !have_data) return kErrFormat;
    if (info.channels == 0 || info.bits_per_sample == 0) return kErrFormat;
    const int64_t bytes_per_frame =
        static_cast<int64_t>(info.channels) * (info.bits_per_sample / 8);
    if (bytes_per_frame <= 0) return kErrFormat;

    // data chunk_size is untrusted 32-bit input: clamp to the bytes the file
    // actually holds, so corrupt headers can't drive multi-GB allocations in
    // the decoders downstream.
    f.clear();
    f.seekg(0, std::ios::end);
    const int64_t file_size = static_cast<int64_t>(f.tellg());
    const int64_t available = file_size - info.data_offset;
    if (available <= 0) return kErrFormat;
    if (info.data_bytes > available) {
        info.data_bytes = available;
    }

    info.frames = info.data_bytes / bytes_per_frame;
    return 0;
}

// Decode the sample data region to float32 interleaved.
int decode_wav(const std::string& path, const WavInfo& info, float* out, int64_t capacity) {
    const int64_t total = info.frames * info.channels;
    if (total > capacity) return kErrCapacity;
    // zero-frame file (e.g. data chunk smaller than one frame): nothing to
    // decode — and memcpy/loops below must not run on an empty vector's
    // (possibly null) data() pointer (UBSan: "null passed as argument
    // declared never-null")
    if (total == 0) return 0;

    std::ifstream f(path, std::ios::binary);
    if (!f) return kErrOpen;
    f.seekg(info.data_offset);

    const int bytes_per_sample = info.bits_per_sample / 8;
    const int64_t raw_bytes = total * bytes_per_sample;
    std::vector<char> raw(static_cast<size_t>(raw_bytes));
    if (!read_exact(f, raw.data(), static_cast<size_t>(raw_bytes))) return kErrFormat;

    const char* src = raw.data();
    if (info.format == 1 && info.bits_per_sample == 16) {
        const int16_t* s = reinterpret_cast<const int16_t*>(src);
        for (int64_t i = 0; i < total; ++i) out[i] = static_cast<float>(s[i]) / 32768.0f;
    } else if (info.format == 1 && info.bits_per_sample == 32) {
        const int32_t* s = reinterpret_cast<const int32_t*>(src);
        for (int64_t i = 0; i < total; ++i)
            out[i] = static_cast<float>(static_cast<double>(s[i]) / 2147483648.0);
    } else if (info.format == 1 && info.bits_per_sample == 24) {
        for (int64_t i = 0; i < total; ++i) {
            const unsigned char* p =
                reinterpret_cast<const unsigned char*>(src) + i * 3;
            int32_t v = (static_cast<int32_t>(p[2]) << 24) |
                        (static_cast<int32_t>(p[1]) << 16) |
                        (static_cast<int32_t>(p[0]) << 8);
            out[i] = static_cast<float>(static_cast<double>(v) / 2147483648.0);
        }
    } else if (info.format == 3 && info.bits_per_sample == 32) {
        std::memcpy(out, src, static_cast<size_t>(total) * sizeof(float));
    } else if (info.format == 3 && info.bits_per_sample == 64) {
        const double* s = reinterpret_cast<const double*>(src);
        for (int64_t i = 0; i < total; ++i) out[i] = static_cast<float>(s[i]);
    } else {
        return kErrUnsupported;
    }

    // clip to [-1, 1] (io.py:105-111 convention)
    for (int64_t i = 0; i < total; ++i) {
        float v = out[i];
        out[i] = v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
    }
    return 0;
}

}  // namespace

extern "C" {

int aa_read_wav_info(const char* path, int64_t* frames, int32_t* channels,
                     int32_t* sample_rate) {
    WavInfo info;
    int rc = probe_wav(path, info);
    if (rc != 0) return rc;
    *frames = info.frames;
    *channels = info.channels;
    *sample_rate = static_cast<int32_t>(info.sample_rate);
    return 0;
}

int aa_read_wav_f32(const char* path, float* out, int64_t capacity) {
    WavInfo info;
    int rc = probe_wav(path, info);
    if (rc != 0) return rc;
    return decode_wav(path, info, out, capacity);
}

int aa_write_wav_pcm16(const char* path, const int16_t* data, int64_t frames,
                       int32_t channels, int32_t sample_rate) {
    std::ofstream f(path, std::ios::binary);
    if (!f) return kErrOpen;

    const uint32_t data_bytes = static_cast<uint32_t>(frames * channels * 2);
    auto put16 = [&f](uint16_t v) { f.write(reinterpret_cast<const char*>(&v), 2); };
    auto put32 = [&f](uint32_t v) { f.write(reinterpret_cast<const char*>(&v), 4); };

    f.write("RIFF", 4);
    put32(36u + data_bytes);
    f.write("WAVE", 4);
    f.write("fmt ", 4);
    put32(16u);
    put16(1u);
    put16(static_cast<uint16_t>(channels));
    put32(static_cast<uint32_t>(sample_rate));
    put32(static_cast<uint32_t>(sample_rate) * channels * 2u);
    put16(static_cast<uint16_t>(channels * 2));
    put16(16u);
    f.write("data", 4);
    put32(data_bytes);
    f.write(reinterpret_cast<const char*>(data), data_bytes);
    return f ? 0 : kErrWrite;
}

// Parallel bundle decode into one zero-padded (num_files, n_max, out_channels)
// float32 buffer. Mono taps are duplicated across output channels; lengths[i]
// receives each tap's frame count. Returns 0, or the first error code.
int aa_read_bundle_f32(const char** paths, int32_t num_files, float* out,
                       int64_t n_max, int32_t out_channels, int64_t* lengths,
                       int32_t num_threads) {
    std::atomic<int> next{0};
    std::atomic<int> err{0};

    auto worker = [&]() {
        std::vector<float> scratch;
        try {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= num_files || err.load() != 0) return;

            WavInfo info;
            int rc = probe_wav(paths[i], info);
            if (rc != 0) { err.store(rc); return; }

            // only the frames that fit the output are decoded (the data
            // region is a contiguous prefix)
            const int64_t frames = std::min<int64_t>(info.frames, n_max);
            WavInfo capped = info;
            capped.frames = frames;
            scratch.resize(static_cast<size_t>(frames) * info.channels);
            rc = decode_wav(paths[i], capped, scratch.data(),
                            static_cast<int64_t>(scratch.size()));
            if (rc != 0) { err.store(rc); return; }

            float* dst = out + static_cast<int64_t>(i) * n_max * out_channels;
            const int in_ch = info.channels;
            for (int64_t fidx = 0; fidx < frames; ++fidx) {
                for (int c = 0; c < out_channels; ++c) {
                    const int src_c = in_ch == 1 ? 0 : (c < in_ch ? c : in_ch - 1);
                    dst[fidx * out_channels + c] = scratch[fidx * in_ch + src_c];
                }
            }
            lengths[i] = frames;
        }
        } catch (...) {
            // an exception escaping a thread entry point would terminate
            // the whole process; convert to an error code instead
            err.store(kErrFormat);
        }
    };

    const int threads = std::max(1, std::min<int>(num_threads, num_files));
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
    return err.load();
}

// PCM16 fast path: decode a bundle into a zero-padded PLANAR int16 buffer
// (num_files, out_channels, n_max) — a straight deinterleave, no float
// conversion. The device converts to float32 (/32768) on-chip, so both the
// host decode and the host->device transfer move half the bytes of the f32
// path. Returns kErrUnsupported for any non-PCM16 tap (caller falls back).
int aa_read_bundle_planar_i16(const char** paths, int32_t num_files,
                              int16_t* out, int64_t n_max,
                              int32_t out_channels, int64_t* lengths,
                              int32_t num_threads) {
    std::atomic<int> next{0};
    std::atomic<int> err{0};

    auto worker = [&]() {
        std::vector<char> raw;
        try {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= num_files || err.load() != 0) return;

            WavInfo info;
            int rc = probe_wav(paths[i], info);
            if (rc != 0) { err.store(rc); return; }
            if (info.format != 1 || info.bits_per_sample != 16) {
                err.store(kErrUnsupported);
                return;
            }

            std::ifstream f(paths[i], std::ios::binary);
            if (!f) { err.store(kErrOpen); return; }
            f.seekg(info.data_offset);
            const int in_ch = info.channels;
            // only the frames that fit the output are read (contiguous prefix)
            const int64_t frames = std::min<int64_t>(info.frames, n_max);
            const int64_t raw_bytes = frames * in_ch * 2;
            raw.resize(static_cast<size_t>(raw_bytes));
            if (!read_exact(f, raw.data(), static_cast<size_t>(raw_bytes))) {
                err.store(kErrFormat);
                return;
            }
            const int16_t* src = reinterpret_cast<const int16_t*>(raw.data());

            int16_t* base = out + static_cast<int64_t>(i) * out_channels * n_max;
            for (int c = 0; c < out_channels; ++c) {
                const int src_c = in_ch == 1 ? 0 : (c < in_ch ? c : in_ch - 1);
                int16_t* dst = base + static_cast<int64_t>(c) * n_max;
                for (int64_t fidx = 0; fidx < frames; ++fidx) {
                    dst[fidx] = src[fidx * in_ch + src_c];
                }
            }
            lengths[i] = frames;
        }
        } catch (...) {
            err.store(kErrFormat);
        }
    };

    const int threads = std::max(1, std::min<int>(num_threads, num_files));
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
    return err.load();
}

}  // extern "C"
