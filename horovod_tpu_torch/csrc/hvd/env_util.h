// Shared env-integer parsers for the native core. One grammar for every
// numeric knob: the whole value must parse as a base-10 integer, else the
// coded default — never a prefix parse. (Boolean knobs go through
// operations.cc's EnvFlag, which mirrors the Python config's _get_bool.)

// Thread posture: getenv-only readers, called during init paths before
// worker threads exist (the env itself is never mutated by the core).
//
#ifndef HVD_ENV_UTIL_H_
#define HVD_ENV_UTIL_H_

#include <cstdlib>

namespace hvd {

inline long long EnvLL(const char* name, long long dflt) {
  const char* e = std::getenv(name);
  if (e == nullptr || *e == 0) return dflt;
  char* end = nullptr;
  long long n = std::strtoll(e, &end, 10);
  return (end != nullptr && *end == 0) ? n : dflt;
}

// Positive-only variant for timeouts and sizes: zero or negative values
// fall back to the default instead of disabling the bound.
inline long long EnvMs(const char* name, long long dflt) {
  long long v = EnvLL(name, dflt);
  return v > 0 ? v : dflt;
}

}  // namespace hvd

#endif  // HVD_ENV_UTIL_H_
