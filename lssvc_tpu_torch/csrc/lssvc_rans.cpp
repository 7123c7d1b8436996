// lssvc_rans — the port's native entropy coder, a copy of the JAX package's
// lssvc_tpu/native/lssvc_rans.cpp (the port builds and loads its own).
//
// 64-bit range ANS (rANS) over 16-bit quantized CDFs with a 4-bit bypass
// escape for out-of-range symbols, exposed through a batch-oriented C API
// (arrays in, arrays out — no per-element binding overhead).  The stream
// format is the reference coder's (src/cpp/rans/rans_interface.cpp of the
// LSSVC reference code): the same rans64 state machine (Fabian Giesen's
// public-domain construction), the same 32-bit word stream emitted in
// reverse at flush, the same bypass escape layout.
//
// Also provides pmf_to_quantized_cdf with the same integer quantization +
// frequency-stealing behavior as the reference CDF builder
// (src/cpp/ops/ops.cpp:24-82), so CDF tables are bit-exact.
//
// Build (lssvc_tpu_torch/build.py): g++ -O3 -std=c++17 -shared -fPIC

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

constexpr uint64_t kRansL = 1ull << 31;      // renormalization threshold
constexpr int kProbBits = 16;                // CDF precision
constexpr uint32_t kBypassBits = 4;          // raw-bit escape chunk size
constexpr uint32_t kMaxBypass = (1u << kBypassBits) - 1;

struct Sym {
  uint16_t start;
  uint16_t range;
  bool raw;  // bypass: emit `start` as kBypassBits raw bits
};

// --- rans64 state machine ---------------------------------------------------

inline void enc_put(uint64_t& x, uint32_t*& ptr, uint32_t start, uint32_t freq,
                    int scale_bits) {
  const uint64_t x_max = ((kRansL >> scale_bits) << 32) * freq;
  if (x >= x_max) {
    *--ptr = static_cast<uint32_t>(x);
    x >>= 32;
  }
  x = ((x / freq) << scale_bits) + (x % freq) + start;
}

inline void enc_put_bits(uint64_t& x, uint32_t*& ptr, uint32_t val, int nbits) {
  const uint32_t freq = 1u << (kProbBits - nbits);
  const uint64_t x_max = ((kRansL >> kProbBits) << 32) * freq;
  if (x >= x_max) {
    *--ptr = static_cast<uint32_t>(x);
    x >>= 32;
  }
  x = (x << nbits) | val;
}

inline void enc_flush(uint64_t x, uint32_t*& ptr) {
  ptr -= 2;
  ptr[0] = static_cast<uint32_t>(x);
  ptr[1] = static_cast<uint32_t>(x >> 32);
}

inline uint64_t dec_init(const uint32_t*& ptr) {
  uint64_t x = static_cast<uint64_t>(ptr[0]) |
               (static_cast<uint64_t>(ptr[1]) << 32);
  ptr += 2;
  return x;
}

inline uint32_t dec_peek(uint64_t x, int scale_bits) {
  return static_cast<uint32_t>(x & ((1ull << scale_bits) - 1));
}

// Renormalising reads stop at `end` (zeros past it), so a corrupt or
// foreign stream decodes to garbage but never reads out of bounds.
inline void dec_advance(uint64_t& x, const uint32_t*& ptr,
                        const uint32_t* end, uint32_t start, uint32_t freq,
                        int scale_bits) {
  const uint64_t mask = (1ull << scale_bits) - 1;
  x = freq * (x >> scale_bits) + (x & mask) - start;
  if (x < kRansL) {
    x = (x << 32) | (ptr < end ? *ptr++ : 0u);
  }
}

inline uint32_t dec_get_bits(uint64_t& x, const uint32_t*& ptr,
                             const uint32_t* end, int nbits) {
  const uint32_t val = static_cast<uint32_t>(x & ((1u << nbits) - 1));
  x >>= nbits;
  if (x < kRansL) {
    x = (x << 32) | (ptr < end ? *ptr++ : 0u);
  }
  return val;
}

// --- encoder ----------------------------------------------------------------

struct Encoder {
  std::vector<Sym> syms;
  std::vector<uint8_t> out;

  void push_value(int32_t value, const int32_t* cdf, int32_t cdf_size,
                  int32_t offset) {
    const int32_t max_value = cdf_size - 2;
    int32_t v = value - offset;
    // 64-bit: the nibble-count loop shifts by n_bypass*kBypassBits, which
    // reaches 32 for |raw_val| >= 2^28 — a 32-bit shift of 32 is UB (x86
    // masks the count, turning the loop infinite; caught by the fuzz test)
    uint64_t raw_val = 0;
    if (v < 0) {
      raw_val = static_cast<uint64_t>(int64_t{-2} * v - 1);
      v = max_value;
    } else if (v >= max_value) {
      raw_val = static_cast<uint64_t>(int64_t{2} * (v - max_value));
      v = max_value;
    }
    syms.push_back({static_cast<uint16_t>(cdf[v]),
                    static_cast<uint16_t>(cdf[v + 1] - cdf[v]), false});
    if (v == max_value) {
      // escape: count kBypassBits-sized digits of raw_val
      int32_t n_bypass = 0;
      while ((raw_val >> (n_bypass * kBypassBits)) != 0) ++n_bypass;
      int32_t nb = n_bypass;
      while (nb >= static_cast<int32_t>(kMaxBypass)) {
        syms.push_back({static_cast<uint16_t>(kMaxBypass),
                        static_cast<uint16_t>(kMaxBypass + 1), true});
        nb -= kMaxBypass;
      }
      syms.push_back({static_cast<uint16_t>(nb),
                      static_cast<uint16_t>(nb + 1), true});
      for (int32_t j = 0; j < n_bypass; ++j) {
        const uint32_t d = (raw_val >> (j * kBypassBits)) & kMaxBypass;
        syms.push_back({static_cast<uint16_t>(d),
                        static_cast<uint16_t>(d + 1), true});
      }
    }
  }

  int64_t flush() {
    std::vector<uint32_t> buf(syms.size() + 2);
    uint32_t* ptr = buf.data() + buf.size();
    uint64_t x = kRansL;
    for (auto it = syms.rbegin(); it != syms.rend(); ++it) {
      if (!it->raw) {
        enc_put(x, ptr, it->start, it->range, kProbBits);
      } else {
        enc_put_bits(x, ptr, it->start, kBypassBits);
      }
    }
    enc_flush(x, ptr);
    syms.clear();
    const size_t nbytes =
        (buf.data() + buf.size() - ptr) * sizeof(uint32_t);
    out.assign(reinterpret_cast<uint8_t*>(ptr),
               reinterpret_cast<uint8_t*>(ptr) + nbytes);
    return static_cast<int64_t>(out.size());
  }
};

// --- decoder ----------------------------------------------------------------

struct Decoder {
  std::vector<uint8_t> stream;
  const uint32_t* ptr = nullptr;
  const uint32_t* end = nullptr;
  uint64_t x = 0;
  // optional stored CDF tables (set_cdf / decode_stream_only_indexes)
  std::vector<int32_t> cdfs;
  std::vector<int32_t> cdf_sizes;
  std::vector<int32_t> offsets;
  int32_t cdf_stride = 0;

  void set_stream(const uint8_t* data, int64_t n) {
    stream.assign(data, data + n);
    // pad so renormalization reads past the logical end stay in-bounds
    stream.resize(((n + 3) / 4 + 2) * 4, 0);
    ptr = reinterpret_cast<const uint32_t*>(stream.data());
    end = ptr + stream.size() / 4;
    x = dec_init(ptr);
  }

  int32_t decode_one(const int32_t* cdf, int32_t cdf_size, int32_t offset) {
    const int32_t max_value = cdf_size - 2;
    const uint32_t cum = dec_peek(x, kProbBits);
    // cdf strictly increasing -> binary search for the symbol slot
    const int32_t* it = std::upper_bound(
        cdf, cdf + cdf_size, static_cast<int32_t>(cum));
    int32_t s = static_cast<int32_t>(it - cdf) - 1;
    dec_advance(x, ptr, end, cdf[s], cdf[s + 1] - cdf[s], kProbBits);
    int32_t value = s;
    if (value == max_value) {
      uint32_t val = dec_get_bits(x, ptr, end, kBypassBits);
      uint32_t n_bypass = val;
      while (val == kMaxBypass) {
        val = dec_get_bits(x, ptr, end, kBypassBits);
        n_bypass += val;
      }
      // 64-bit: j*kBypassBits reaches 32 for deep escapes (see encoder);
      // digits past 64 bits occur only in a corrupt stream and are dropped
      uint64_t raw_val = 0;
      for (uint32_t j = 0; j < n_bypass; ++j) {
        const uint64_t d = dec_get_bits(x, ptr, end, kBypassBits);
        if (j * kBypassBits < 64) raw_val |= d << (j * kBypassBits);
      }
      value = static_cast<int32_t>(raw_val >> 1);
      if (raw_val & 1) {
        value = -value - 1;
      } else {
        value += max_value;
      }
    }
    return value + offset;
  }
};

}  // namespace

extern "C" {

void* rans_encoder_new() { return new Encoder(); }
void rans_encoder_delete(void* h) { delete static_cast<Encoder*>(h); }
void rans_encoder_reset(void* h) { static_cast<Encoder*>(h)->syms.clear(); }

void rans_encoder_encode_with_indexes(void* h, const int32_t* symbols,
                                      const int32_t* indexes, int64_t n,
                                      const int32_t* cdfs, int32_t cdf_stride,
                                      const int32_t* cdf_sizes,
                                      const int32_t* offsets) {
  Encoder* enc = static_cast<Encoder*>(h);
  enc->syms.reserve(enc->syms.size() + static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    enc->push_value(symbols[i], cdfs + static_cast<int64_t>(idx) * cdf_stride,
                    cdf_sizes[idx], offsets[idx]);
  }
}

int64_t rans_encoder_flush(void* h) {
  return static_cast<Encoder*>(h)->flush();
}

const uint8_t* rans_encoder_get_bytes(void* h) {
  return static_cast<Encoder*>(h)->out.data();
}

void* rans_decoder_new() { return new Decoder(); }
void rans_decoder_delete(void* h) { delete static_cast<Decoder*>(h); }

void rans_decoder_set_stream(void* h, const uint8_t* data, int64_t n) {
  static_cast<Decoder*>(h)->set_stream(data, n);
}

void rans_decoder_set_cdf(void* h, const int32_t* cdfs, int32_t cdf_stride,
                          int32_t n_cdfs, const int32_t* cdf_sizes,
                          const int32_t* offsets) {
  Decoder* dec = static_cast<Decoder*>(h);
  dec->cdfs.assign(cdfs, cdfs + static_cast<int64_t>(n_cdfs) * cdf_stride);
  dec->cdf_sizes.assign(cdf_sizes, cdf_sizes + n_cdfs);
  dec->offsets.assign(offsets, offsets + n_cdfs);
  dec->cdf_stride = cdf_stride;
}

void rans_decoder_decode_stream(void* h, const int32_t* indexes, int64_t n,
                                const int32_t* cdfs, int32_t cdf_stride,
                                const int32_t* cdf_sizes,
                                const int32_t* offsets, int32_t* out) {
  Decoder* dec = static_cast<Decoder*>(h);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    out[i] = dec->decode_one(cdfs + static_cast<int64_t>(idx) * cdf_stride,
                             cdf_sizes[idx], offsets[idx]);
  }
}

void rans_decoder_decode_stream_only_indexes(void* h, const int32_t* indexes,
                                             int64_t n, int32_t* out) {
  Decoder* dec = static_cast<Decoder*>(h);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    out[i] = dec->decode_one(
        dec->cdfs.data() + static_cast<int64_t>(idx) * dec->cdf_stride,
        dec->cdf_sizes[idx], dec->offsets[idx]);
  }
}

// --- CDF quantizer ----------------------------------------------------------

// Writes pmf_size+1 entries into `out`; returns 0 on success, -1 if a
// zero-frequency slot could not be repaired.
int32_t pmf_to_quantized_cdf(const float* pmf, int32_t pmf_size,
                             int32_t precision, uint32_t* out) {
  const int32_t n = pmf_size + 1;
  out[0] = 0;
  for (int32_t i = 0; i < pmf_size; ++i) {
    out[i + 1] = static_cast<uint32_t>(
        std::round(pmf[i] * (1u << precision)) + 0.5);
  }
  uint32_t total = std::accumulate(out, out + n, 0u);
  if (total == 0) return -1;
  for (int32_t i = 0; i < n; ++i) {
    out[i] = static_cast<uint32_t>(
        ((1ull << precision) * out[i]) / total);
  }
  std::partial_sum(out, out + n, out);
  out[n - 1] = 1u << precision;

  for (int32_t i = 0; i < n - 1; ++i) {
    if (out[i] == out[i + 1]) {
      // steal one count from the smallest frequency > 1
      uint32_t best_freq = ~0u;
      int32_t best_steal = -1;
      for (int32_t j = 0; j < n - 1; ++j) {
        const uint32_t freq = out[j + 1] - out[j];
        if (freq > 1 && freq < best_freq) {
          best_freq = freq;
          best_steal = j;
        }
      }
      if (best_steal == -1) return -1;
      if (best_steal < i) {
        for (int32_t j = best_steal + 1; j <= i; ++j) out[j]--;
      } else {
        for (int32_t j = i + 1; j <= best_steal; ++j) out[j]++;
      }
    }
  }
  return 0;
}

}  // extern "C"
