// Minimal native FLAC decoder for the ssd_tpu_torch data loader (a copy of
// the JAX package's native/flac_decoder.cpp).
//
// The reference pipeline reads the Gaddy & Klein corpus FLAC audio through
// torchaudio/libsndfile (src/data/preprocessing.py:139-145). This image ships
// neither, so the teacher featurizer needs its own decoder. Scope: the FLAC
// subset produced by the reference encoder chain — 16-bit, 1-2 channels,
// constant/verbatim/fixed/LPC subframes, Rice/Rice2 residuals, all stereo
// decorrelation modes. CRCs are parsed but not verified (cache integrity is
// handled at a higher level).
//
// C API (ctypes-friendly):
//   int flac_decode(const uint8_t* data, size_t len,
//                   int32_t* out, size_t out_capacity,
//                   FlacInfo* info);
// Returns number of interleaved samples written, or a negative error code.
// Call with out=nullptr to query the required capacity via info.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

struct FlacInfo {
  uint32_t sample_rate;
  uint32_t channels;
  uint32_t bits_per_sample;
  uint64_t total_samples;  // per channel
};

}  // extern "C"

namespace {

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t len) : data_(data), len_(len) {}

  bool eof() const { return byte_pos_ >= len_ && bit_pos_ == 0; }
  size_t byte_pos() const { return byte_pos_; }

  void align() {
    if (bit_pos_ != 0) {
      bit_pos_ = 0;
      ++byte_pos_;
    }
  }

  // Read up to 32 bits MSB-first. Returns false on EOF.
  bool read(uint32_t nbits, uint64_t* out) {
    uint64_t v = 0;
    for (uint32_t i = 0; i < nbits; ++i) {
      if (byte_pos_ >= len_) return false;
      v = (v << 1) | ((data_[byte_pos_] >> (7 - bit_pos_)) & 1u);
      if (++bit_pos_ == 8) {
        bit_pos_ = 0;
        ++byte_pos_;
      }
    }
    *out = v;
    return true;
  }

  bool read_signed(uint32_t nbits, int64_t* out) {
    uint64_t v;
    if (!read(nbits, &v)) return false;
    // sign extend
    if (nbits > 0 && (v >> (nbits - 1)) & 1u) {
      v |= ~((1ull << nbits) - 1);
    }
    *out = static_cast<int64_t>(v);
    return true;
  }

  // Unary-coded value: count of 0 bits before the terminating 1.
  bool read_unary(uint64_t* out) {
    uint64_t count = 0;
    while (true) {
      if (byte_pos_ >= len_) return false;
      uint32_t bit = (data_[byte_pos_] >> (7 - bit_pos_)) & 1u;
      if (++bit_pos_ == 8) {
        bit_pos_ = 0;
        ++byte_pos_;
      }
      if (bit) break;
      ++count;
      if (count > 1u << 24) return false;  // corrupt stream guard
    }
    *out = count;
    return true;
  }

  // Rice-coded signed residual with parameter k.
  bool read_rice(uint32_t k, int64_t* out) {
    uint64_t q, r = 0;
    if (!read_unary(&q)) return false;
    if (k > 0 && !read(k, &r)) return false;
    uint64_t v = (q << k) | r;
    // zigzag decode
    *out = (v & 1) ? -static_cast<int64_t>(v >> 1) - 1
                   : static_cast<int64_t>(v >> 1);
    return true;
  }

  // UTF-8-style coded number (frame header sample/frame number).
  bool read_utf8(uint64_t* out) {
    uint64_t b0;
    if (!read(8, &b0)) return false;
    uint32_t extra = 0;
    uint64_t v = 0;
    if (b0 < 0x80) {
      *out = b0;
      return true;
    } else if ((b0 & 0xE0) == 0xC0) {
      extra = 1;
      v = b0 & 0x1F;
    } else if ((b0 & 0xF0) == 0xE0) {
      extra = 2;
      v = b0 & 0x0F;
    } else if ((b0 & 0xF8) == 0xF0) {
      extra = 3;
      v = b0 & 0x07;
    } else if ((b0 & 0xFC) == 0xF8) {
      extra = 4;
      v = b0 & 0x03;
    } else if ((b0 & 0xFE) == 0xFC) {
      extra = 5;
      v = b0 & 0x01;
    } else if (b0 == 0xFE) {
      extra = 6;
      v = 0;
    } else {
      return false;
    }
    for (uint32_t i = 0; i < extra; ++i) {
      uint64_t b;
      if (!read(8, &b)) return false;
      if ((b & 0xC0) != 0x80) return false;
      v = (v << 6) | (b & 0x3F);
    }
    *out = v;
    return true;
  }

 private:
  const uint8_t* data_;
  size_t len_;
  size_t byte_pos_ = 0;
  uint32_t bit_pos_ = 0;
};

struct SubframeResult {
  std::vector<int64_t> samples;
};

bool decode_residual(BitReader& br, uint32_t block_size, uint32_t order,
                     std::vector<int64_t>* residual) {
  uint64_t method, partition_order;
  if (!br.read(2, &method)) return false;
  if (method > 1) return false;
  uint32_t param_bits = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  if (!br.read(4, &partition_order)) return false;
  uint32_t partitions = 1u << partition_order;
  if (block_size % partitions != 0) return false;
  uint32_t part_len = block_size >> partition_order;
  if (part_len <= 0) return false;
  // FLAC spec: the first partition holds (part_len - order) samples, so it
  // must have more than `order` — otherwise `count` underflows on a corrupt
  // stream and the loop below allocates unbounded scratch before EOF.
  if (part_len <= order) return false;

  residual->clear();
  residual->reserve(block_size - order);
  for (uint32_t p = 0; p < partitions; ++p) {
    uint32_t count = part_len - (p == 0 ? order : 0);
    uint64_t param;
    if (!br.read(param_bits, &param)) return false;
    if (param == escape) {
      uint64_t raw_bits;
      if (!br.read(5, &raw_bits)) return false;
      for (uint32_t i = 0; i < count; ++i) {
        int64_t v = 0;
        if (raw_bits > 0) {
          if (!br.read_signed(static_cast<uint32_t>(raw_bits), &v)) return false;
        }
        residual->push_back(v);
      }
    } else {
      for (uint32_t i = 0; i < count; ++i) {
        int64_t v;
        if (!br.read_rice(static_cast<uint32_t>(param), &v)) return false;
        residual->push_back(v);
      }
    }
  }
  return true;
}

bool decode_subframe(BitReader& br, uint32_t block_size, uint32_t bps,
                     SubframeResult* out) {
  uint64_t pad, type_code, has_wasted;
  if (!br.read(1, &pad) || pad != 0) return false;
  if (!br.read(6, &type_code)) return false;
  if (!br.read(1, &has_wasted)) return false;
  uint32_t wasted = 0;
  if (has_wasted) {
    uint64_t u;
    if (!br.read_unary(&u)) return false;
    wasted = static_cast<uint32_t>(u) + 1;
  }
  uint32_t eff_bps = bps - wasted;
  auto& s = out->samples;
  s.assign(block_size, 0);

  if (type_code == 0) {  // CONSTANT
    int64_t v;
    if (!br.read_signed(eff_bps, &v)) return false;
    for (auto& x : s) x = v;
  } else if (type_code == 1) {  // VERBATIM
    for (uint32_t i = 0; i < block_size; ++i) {
      if (!br.read_signed(eff_bps, &s[i])) return false;
    }
  } else if (type_code >= 8 && type_code <= 12) {  // FIXED, order 0-4
    uint32_t order = static_cast<uint32_t>(type_code) - 8;
    for (uint32_t i = 0; i < order; ++i) {
      if (!br.read_signed(eff_bps, &s[i])) return false;
    }
    std::vector<int64_t> residual;
    if (!decode_residual(br, block_size, order, &residual)) return false;
    for (uint32_t i = order; i < block_size; ++i) {
      int64_t r = residual[i - order];
      switch (order) {
        case 0: s[i] = r; break;
        case 1: s[i] = r + s[i - 1]; break;
        case 2: s[i] = r + 2 * s[i - 1] - s[i - 2]; break;
        case 3: s[i] = r + 3 * s[i - 1] - 3 * s[i - 2] + s[i - 3]; break;
        case 4:
          s[i] = r + 4 * s[i - 1] - 6 * s[i - 2] + 4 * s[i - 3] - s[i - 4];
          break;
      }
    }
  } else if (type_code >= 32) {  // LPC, order = code - 31
    uint32_t order = static_cast<uint32_t>(type_code) - 31;
    for (uint32_t i = 0; i < order; ++i) {
      if (!br.read_signed(eff_bps, &s[i])) return false;
    }
    uint64_t precision_m1;
    if (!br.read(4, &precision_m1)) return false;
    if (precision_m1 == 0xF) return false;
    uint32_t precision = static_cast<uint32_t>(precision_m1) + 1;
    int64_t shift;
    if (!br.read_signed(5, &shift)) return false;
    if (shift < 0) return false;
    std::vector<int64_t> coefs(order);
    for (uint32_t i = 0; i < order; ++i) {
      if (!br.read_signed(precision, &coefs[i])) return false;
    }
    std::vector<int64_t> residual;
    if (!decode_residual(br, block_size, order, &residual)) return false;
    for (uint32_t i = order; i < block_size; ++i) {
      __int128 acc = 0;
      for (uint32_t j = 0; j < order; ++j) {
        acc += static_cast<__int128>(coefs[j]) * s[i - 1 - j];
      }
      s[i] = residual[i - order] + static_cast<int64_t>(acc >> shift);
    }
  } else {
    return false;  // reserved
  }

  if (wasted > 0) {
    for (auto& x : s) x <<= wasted;
  }
  return true;
}

const uint32_t kBlockSizes[16] = {0,    192,  576,  1152, 2304, 4608, 0,    0,
                                  256,  512,  1024, 2048, 4096, 8192, 16384, 32768};
const uint32_t kSampleRates[16] = {0,     88200, 176400, 192000, 8000,  16000,
                                   22050, 24000, 32000,  44100,  48000, 96000,
                                   0,     0,     0,      0};

}  // namespace

extern "C" {

// Returns: >=0 number of interleaved int32 samples, or negative error:
// -1 bad magic, -2 bad metadata, -3 bad frame, -4 capacity query/overflow.
long long flac_decode(const uint8_t* data, size_t len, int32_t* out,
                      size_t out_capacity, FlacInfo* info) {
  if (len < 42 || memcmp(data, "fLaC", 4) != 0) return -1;
  size_t pos = 4;

  uint32_t channels = 0, bps = 0, sample_rate = 0;
  uint64_t total_samples = 0;
  bool have_streaminfo = false;

  // metadata blocks
  while (pos + 4 <= len) {
    uint8_t header = data[pos];
    bool last = header & 0x80;
    uint8_t type = header & 0x7F;
    uint32_t block_len =
        (data[pos + 1] << 16) | (data[pos + 2] << 8) | data[pos + 3];
    pos += 4;
    if (pos + block_len > len) return -2;
    if (type == 0 && block_len >= 34) {
      const uint8_t* s = data + pos;
      sample_rate = (s[10] << 12) | (s[11] << 4) | (s[12] >> 4);
      channels = ((s[12] >> 1) & 0x7) + 1;
      bps = (((s[12] & 1) << 4) | (s[13] >> 4)) + 1;
      total_samples = (static_cast<uint64_t>(s[13] & 0x0F) << 32) |
                      (static_cast<uint64_t>(s[14]) << 24) | (s[15] << 16) |
                      (s[16] << 8) | s[17];
      have_streaminfo = true;
    }
    pos += block_len;
    if (last) break;
  }
  if (!have_streaminfo || channels == 0 || channels > 8) return -2;

  if (info) {
    info->sample_rate = sample_rate;
    info->channels = channels;
    info->bits_per_sample = bps;
    info->total_samples = total_samples;
  }
  if (out == nullptr) return -4;  // capacity query: info is filled

  BitReader br(data + pos, len - pos);
  std::vector<SubframeResult> subframes(channels);
  size_t written = 0;

  while (true) {
    br.align();
    uint64_t sync;
    if (!br.read(14, &sync)) break;  // clean EOF
    if (sync != 0x3FFE) return -3;
    uint64_t reserved, blocking;
    if (!br.read(1, &reserved) || !br.read(1, &blocking)) return -3;
    uint64_t bs_code, sr_code, ch_code, ss_code, reserved2;
    if (!br.read(4, &bs_code) || !br.read(4, &sr_code) || !br.read(4, &ch_code) ||
        !br.read(3, &ss_code) || !br.read(1, &reserved2))
      return -3;

    uint64_t frame_number;
    if (!br.read_utf8(&frame_number)) return -3;

    uint32_t block_size;
    if (bs_code == 6) {
      uint64_t v;
      if (!br.read(8, &v)) return -3;
      block_size = static_cast<uint32_t>(v) + 1;
    } else if (bs_code == 7) {
      uint64_t v;
      if (!br.read(16, &v)) return -3;
      block_size = static_cast<uint32_t>(v) + 1;
    } else {
      block_size = kBlockSizes[bs_code];
      if (block_size == 0) return -3;
    }

    if (sr_code == 12) {
      uint64_t v;
      if (!br.read(8, &v)) return -3;
    } else if (sr_code == 13 || sr_code == 14) {
      uint64_t v;
      if (!br.read(16, &v)) return -3;
    }

    uint32_t frame_bps = bps;
    switch (ss_code) {
      case 0: break;  // from streaminfo
      case 1: frame_bps = 8; break;
      case 2: frame_bps = 12; break;
      case 4: frame_bps = 16; break;
      case 5: frame_bps = 20; break;
      case 6: frame_bps = 24; break;
      case 7: frame_bps = 32; break;
      default: return -3;
    }

    uint64_t crc8;
    if (!br.read(8, &crc8)) return -3;

    uint32_t n_ch = channels;
    if (ch_code <= 7) {
      n_ch = static_cast<uint32_t>(ch_code) + 1;
      if (n_ch != channels) return -3;
      for (uint32_t c = 0; c < n_ch; ++c) {
        if (!decode_subframe(br, block_size, frame_bps, &subframes[c])) return -3;
      }
    } else if (ch_code == 8) {  // left/side
      if (channels != 2) return -3;
      if (!decode_subframe(br, block_size, frame_bps, &subframes[0])) return -3;
      if (!decode_subframe(br, block_size, frame_bps + 1, &subframes[1])) return -3;
      for (uint32_t i = 0; i < block_size; ++i) {
        subframes[1].samples[i] =
            subframes[0].samples[i] - subframes[1].samples[i];
      }
    } else if (ch_code == 9) {  // right/side
      if (channels != 2) return -3;
      if (!decode_subframe(br, block_size, frame_bps + 1, &subframes[0])) return -3;
      if (!decode_subframe(br, block_size, frame_bps, &subframes[1])) return -3;
      for (uint32_t i = 0; i < block_size; ++i) {
        subframes[0].samples[i] =
            subframes[0].samples[i] + subframes[1].samples[i];
      }
    } else if (ch_code == 10) {  // mid/side
      if (channels != 2) return -3;
      if (!decode_subframe(br, block_size, frame_bps, &subframes[0])) return -3;
      if (!decode_subframe(br, block_size, frame_bps + 1, &subframes[1])) return -3;
      for (uint32_t i = 0; i < block_size; ++i) {
        int64_t mid = subframes[0].samples[i];
        int64_t side = subframes[1].samples[i];
        mid = (mid << 1) | (side & 1);
        subframes[0].samples[i] = (mid + side) >> 1;
        subframes[1].samples[i] = (mid - side) >> 1;
      }
    } else {
      return -3;
    }

    br.align();
    uint64_t crc16;
    if (!br.read(16, &crc16)) return -3;

    if (written + static_cast<size_t>(block_size) * channels > out_capacity)
      return -4;
    for (uint32_t i = 0; i < block_size; ++i) {
      for (uint32_t c = 0; c < channels; ++c) {
        out[written++] = static_cast<int32_t>(subframes[c].samples[i]);
      }
    }
  }
  return static_cast<long long>(written);
}

}  // extern "C"
