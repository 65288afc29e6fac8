// float16 / bfloat16 <-> float32 converters.
//
// Parity: reference half.{h,cc} (half.h:37-73) which provides bit-level
// fp16 conversion for MPI sums. TPU-native difference: bfloat16 is the
// first-class 16-bit type on TPU (a simple truncation of float32), fp16 is
// kept for capability parity with frameworks that produce it.

// Thread posture: pure conversion functions, no shared state.
//
#ifndef HVD_HALF_H_
#define HVD_HALF_H_

#include <cstdint>
#include <cstring>

namespace hvd {

inline float Bf16ToFloat(uint16_t b) {
  uint32_t bits = static_cast<uint32_t>(b) << 16;
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

inline uint16_t FloatToBf16(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  if ((bits & 0x7FFFFFFFu) > 0x7F800000u) {
    // NaN: rounding could carry into the exponent and produce +-inf;
    // return a quiet NaN with the sign preserved instead.
    return static_cast<uint16_t>((bits >> 16) | 0x0040u);
  }
  // round-to-nearest-even on the dropped 16 bits
  uint32_t rounding = 0x7FFF + ((bits >> 16) & 1);
  return static_cast<uint16_t>((bits + rounding) >> 16);
}

inline float Fp16ToFloat(uint16_t h) {
  uint32_t sign = (h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t mant = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;  // +-0
    } else {
      // subnormal: normalize
      int e = -1;
      uint32_t m = mant;
      do {
        ++e;
        m <<= 1;
      } while ((m & 0x400) == 0);
      bits = sign | ((127 - 15 - e) << 23) | ((m & 0x3FF) << 13);
    }
  } else if (exp == 0x1F) {
    bits = sign | 0x7F800000u | (mant << 13);  // inf / nan
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

inline uint16_t FloatToFp16(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, 4);
  uint32_t sign = (bits >> 16) & 0x8000u;
  int32_t exp = static_cast<int32_t>((bits >> 23) & 0xFF) - 127 + 15;
  uint32_t mant = bits & 0x7FFFFF;
  if (exp >= 0x1F) return static_cast<uint16_t>(sign | 0x7C00u |
                                                (exp == 0xFF - 127 + 15 && mant
                                                     ? 0x200
                                                     : 0));
  if (exp <= 0) {
    if (exp < -10) return static_cast<uint16_t>(sign);
    mant |= 0x800000;
    uint32_t shift = static_cast<uint32_t>(14 - exp);
    uint32_t half_mant = mant >> shift;
    // round to nearest
    if ((mant >> (shift - 1)) & 1) ++half_mant;
    return static_cast<uint16_t>(sign | half_mant);
  }
  uint16_t h = static_cast<uint16_t>(sign | (exp << 10) | (mant >> 13));
  if (mant & 0x1000) ++h;  // round
  return h;
}

}  // namespace hvd

#endif  // HVD_HALF_H_
